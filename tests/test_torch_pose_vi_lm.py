"""The VI pose LM kernel (`solver/pose_vi_lm_cuda.py`, `csrc/pose_vi_lm.cu`)
and its twin `ba_vi.pose_only_vi_ref`.

On the CPU: the wrapper's input checks, the wrapper's lack of a CPU path,
and `ba_vi.pose_only_vi` on CPU tensors taking the twin (the same bits, no
launch), monocular and 3-row, with and without the marginal. Marked
`card`: the kernel against the twin on the card at the tracker's shapes (O
= 1024 rows, Np = 16384 points, 20 iterations), monocular and 3-row, with
and without the marginal; with gross outliers; a problem whose Cholesky
fails at every iteration (the state is kept); two launches giving the same
bits; views taken as their values; the launch counter; the robust policy
(gates, truncation) read from the Python modules. The card tests skip
without a CUDA device. This file imports no JAX, so on the machine with the
card it runs without the suite's conftest:

    python3 -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_pose_vi_lm.py

Tolerances of the kernel against the twin (`pose_vi_lm_cuda.POSE_VI_LM_*` and
its `twin_gaps`, by which `chip_smoke.py` holds the kernel to its twin on
recorded solves too): both run the
same float32 arithmetic, but the visual sums are taken in another order (a
block reduction against PyTorch's einsum), the 30-d system's products are
associated differently, the Cholesky is a column-by-column one against
LAPACK's blocked one and the marginal's elimination another LU than
LAPACK's. That moves each accepted step by float32 rounding, and where a
candidate's cost ties the current one to rounding the two may accept or
reject differently; a converged state then differs by about the last step.
Hence positions within 1e-4 m (the visual kernel's tolerance,
tests/test_torch_pose_lm.py, inside the mono-vi.stream cell's 0.12 mm);
rotations within 3e-5 rad (the cell's 0.002 deg is 3.5e-5 rad, tighter than
the visual kernel's 1e-4); velocities within 4e-4 m/s, the full gyro bias
within 5e-5 rad/s and the full accelerometer bias within 3e-5 m/s^2 (the
cell's 0.4 mm/s, 0.05 mrad/s and 0.03 mm/s^2: the IMU edges and the prior
hold these to a last step of the same order as the position's over the
frame period); chi2 and inliers as the visual kernel's (1e-2 relative plus
5e-2, 2 inliers: a row on the gate); the marginal within 1e-3 relative in
the Frobenius norm (the port's JAX-parity tolerance for it,
tests/test_torch_solver.py, inside the cell's 0.005).
"""
import math

import numpy as np
import pytest
import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import euroc_noise, predict_navstate, preintegrate
from mc_slam_tpu_torch.solver import ba, ba_vi, factors, lm, pose_vi_lm_cuda

torch.set_num_threads(2)

FX, FY, CX, CY, W, H = 458.654, 457.296, 367.215, 248.375, 752, 480
BF = FX * 0.11
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])
ITERS = 20


def _rodrigues(phi):
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]]) / th
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K


def problem(seed, O, Np, stereo, outliers=0.2, fail=False, device="cpu"):
    """One VI frame's joint solve drawn from `seed`: the last state, 10 IMU
    rows at 200 Hz preintegrated at its biases, the current state's truth as
    their prediction and a start ~2 cm, ~0.5 degree and ~5 cm/s off it; O
    rows seen from the truth of which a share `outliers` are gross outliers
    and ~10 % invalid, their points in an Np-point table; the prior on the
    last state a full information near its linearization point. `fail`:
    every information negated, so that the normal equations are negative
    definite and the Cholesky fails at every iteration. Returns (args,
    kwargs) of ba_vi.pose_only_vi and the true current position."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    last = NavState(P=f32(rng.normal(size=3) * 3), V=f32(rng.normal(size=3)),
                    R=f32(_rodrigues(rng.normal(size=3) * 0.5)),
                    bg=f32([0.003, -0.004, 0.003]), ba=f32([0.03, -0.02, 0.06]),
                    dbg=f32(rng.normal(size=3) * 1e-4), dba=f32(rng.normal(size=3) * 1e-3))
    rows = np.zeros((10, 7))
    rows[:, 0:3] = rng.normal(size=(10, 3)) * 0.3
    rows[:, 3:6] = rng.normal(size=(10, 3)) * 0.5 + np.array([0, 0, 9.81])
    rows[:, 6] = 0.005
    pre = preintegrate(f32(rows), last.bg + last.dbg, last.ba + last.dba,
                       euroc_noise(device="cpu"))
    gw = f32([0.0, 0.0, -9.81])
    true = predict_navstate(last, pre, gw)
    cur0 = true._replace(P=true.P + f32(rng.normal(size=3) * 0.02),
                         V=true.V + f32(rng.normal(size=3) * 0.05),
                         R=true.R @ f32(_rodrigues(rng.normal(size=3) * math.radians(0.5))))
    Rcb = TBC[:3, :3].T
    tcb = -Rcb @ TBC[:3, 3]
    Rt, Pt = true.R.double().numpy(), true.P.double().numpy()
    d = rng.uniform(1.5, 12.0, O)
    u_t, v_t = rng.uniform(0, W, O), rng.uniform(0, H, O)
    Xc = np.stack([(u_t - CX) / FX * d, (v_t - CY) / FY * d, d], 1)
    Xw = (Rt @ (Rcb.T @ (Xc - tcb).T)).T + Pt
    table = rng.normal(size=(Np, 3)) * 5
    idx = rng.choice(Np, O, replace=False)
    table[idx] = Xw
    sig = 1.2 ** rng.integers(0, 8, O)
    u = u_t + rng.normal(size=O) * sig
    v = v_t + rng.normal(size=O) * sig
    out = rng.random(O) < outliers
    u[out], v[out] = rng.uniform(0, W, out.sum()), rng.uniform(0, H, out.sum())
    ur = np.where(rng.random(O) < 0.7, u_t - BF / d + rng.normal(size=O) * sig, -1.0)
    sgn = -1.0 if fail else 1.0
    obs = ba.VisualObs(cam=torch.zeros(O, dtype=torch.int64),
                       pt=torch.as_tensor(idx, dtype=torch.int64), uv=f32(np.stack([u, v], 1)),
                       inv_sigma2=f32(sgn / sig ** 2),
                       valid=f32((rng.random(O) < 0.9).astype(np.float64)),
                       ur=f32(ur) if stereo else None)
    D = np.sqrt(np.r_[np.full(9, 1e3), np.full(3, 1e6), np.full(3, 1e4)])
    S = rng.normal(size=(15, 15)) * 0.05
    info = D[:, None] * (np.eye(15) + S @ S.T) * D[None, :]
    prior = ba_vi.PriorFactor(
        cam=torch.zeros((), dtype=torch.int64),
        ns0=last._replace(P=last.P + f32(rng.normal(size=3) * 1e-3),
                          dba=last.dba + f32(rng.normal(size=3) * 1e-3)),
        info=f32(sgn * info), valid=torch.ones(()))
    info_prv = (sgn * factors.imu_prv_info(pre)).contiguous()   # the inverse's layout is not
    info_bias = sgn * factors.bias_rw_info(pre.dT, 2e-5, 5e-3)
    cam = make_camera(FX, FY, CX, CY, width=W, height=H, device="cpu")
    ext = factors.extrinsics_from_Tbc(TBC, device="cpu")
    args = [cur0, last, pre, f32(table), obs, cam, ext, gw, prior, info_prv, info_bias]
    if device != "cpu":
        args = [_to(a, device) for a in args]
    kw = dict(iters=ITERS, bf=BF if stereo else 0.0)
    return args, kw, Pt


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return type(x)(*[_to(a, device) for a in x])
    return x


# ---------------------------------------------------------------------------
# CPU


_NAMES = ("ns_cur0", "ns_last", "pre", "pts_w", "obs", "camera", "ext", "gw", "prior",
          "info_prv", "info_bias")


def _valid_args():
    args, kw, _ = problem(0, 40, 64, True)
    return dict(zip(_NAMES, args), bf=BF)


def _bad(kind):
    a = _valid_args()
    obs, prior = a["obs"], a["prior"]
    if kind == "device":
        a["gw"] = torch.zeros(3, device="meta")
    elif kind == "dtype":
        a["ns_last"] = a["ns_last"]._replace(V=a["ns_last"].V.double())
    elif kind == "pt_dtype":
        a["obs"] = obs._replace(pt=obs.pt.to(torch.int32))
    elif kind == "cam_dtype":
        a["prior"] = prior._replace(cam=prior.cam.to(torch.int32))
    elif kind == "shape":
        a["info_prv"] = torch.zeros(9, 8)
    elif kind == "pre_shape":
        a["pre"] = a["pre"]._replace(dT=a["pre"].dT.reshape(1))
    elif kind == "rows":
        a["obs"] = obs._replace(valid=obs.valid[:-1].contiguous())
    elif kind == "batch":
        a["ns_cur0"] = a["ns_cur0"]._replace(P=a["ns_cur0"].P[None])
    elif kind == "contiguous":
        a["obs"] = obs._replace(uv=obs.uv.T.contiguous().T)
    elif kind == "prior_contiguous":
        a["prior"] = prior._replace(info=prior.info.T.contiguous().T)
    elif kind == "too_many_rows":
        O = pose_vi_lm_cuda.MAX_OBS + 1
        a["obs"] = ba.VisualObs(cam=torch.zeros(O, dtype=torch.int64),
                                pt=torch.zeros(O, dtype=torch.int64), uv=torch.zeros(O, 2),
                                inv_sigma2=torch.ones(O), valid=torch.ones(O), ur=None)
    elif kind == "no_points":
        a["pts_w"] = torch.zeros(0, 3)
    elif kind == "camera":
        a["camera"] = a["camera"]._replace(fx=a["camera"].fx.double())
    elif kind == "bf":
        a["bf"] = torch.full((1,), BF)
    return a


@pytest.mark.parametrize("kind", ["device", "dtype", "pt_dtype", "cam_dtype", "shape",
                                  "pre_shape", "rows", "batch", "contiguous",
                                  "prior_contiguous", "too_many_rows", "no_points", "camera",
                                  "bf"])
def test_validate_inputs_raises(kind):
    with pytest.raises((ValueError, TypeError)):
        pose_vi_lm_cuda.validate_inputs(**_bad(kind))


def test_validate_inputs_accepts_the_tracker_layout():
    assert pose_vi_lm_cuda.validate_inputs(**_valid_args()) == (40, 64)


def test_wrapper_has_no_cpu_path():
    """The kernel's wrapper raises on CPU tensors: the twin is the
    dispatcher's (`ba_vi.pose_only_vi`), never a fallback of the wrapper."""
    args, kw, _ = problem(0, 40, 64, False)
    with pytest.raises(ValueError, match="no kernel"):
        pose_vi_lm_cuda.pose_only_vi_lm(*args, **kw, gates=(ba.CHI2_MONO, ba.CHI2_STEREO))


@pytest.mark.parametrize("compute_marg", [False, True])
@pytest.mark.parametrize("stereo", [False, True])
def test_cpu_takes_the_twin(stereo, compute_marg):
    """On CPU tensors `pose_only_vi` is its twin, bit for bit, and launches
    nothing; the twin converges on these problems."""
    args, kw, Pt = problem(1, 256, 1024, stereo)
    n0 = pose_vi_lm_cuda.LIB.launches
    got = ba_vi.pose_only_vi(*args, **kw, compute_marg=compute_marg)
    ref = ba_vi.pose_only_vi_ref(*args, **kw, compute_marg=compute_marg)
    assert pose_vi_lm_cuda.LIB.launches == n0
    (ns, chi2, n, Hm), (nsr, chi2r, nr, Hmr) = got, ref
    for a, b in zip(ns + (chi2, n, Hm), nsr + (chi2r, nr, Hmr)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ns.P.shape == (3,) and ns.R.shape == (3, 3) and chi2.shape == (256,)
    assert n.shape == () and n.dtype == torch.int64 and Hm.shape == (15, 15)
    assert np.abs(ns.P.numpy() - Pt).max() < 0.01
    assert (float(Hm.abs().max()) > 0) == compute_marg


def test_cpu_twin_keeps_the_state_when_cholesky_fails():
    """Negative-definite normal equations reject every candidate: the
    current state is kept (R normalized)."""
    args, kw, _ = problem(3, 256, 1024, False, fail=True)
    ns, _, _, _ = ba_vi.pose_only_vi_ref(*args, **kw)
    cur0 = args[0]
    assert torch.equal(ns.P, cur0.P) and torch.equal(ns.V, cur0.V)
    assert torch.equal(ns.dba, cur0.dba)
    assert torch.equal(ns.R, lie.so3_normalize_fast(cur0.R))


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_close(got, ref):
    (ns, chi2, n, Hm), (nsr, chi2r, nr, Hmr) = got, ref
    for a, b in zip(ns, nsr):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert chi2.shape == chi2r.shape and Hm.shape == Hmr.shape == (15, 15)
    assert n.shape == nr.shape == () and n.dtype == nr.dtype == torch.int64
    gaps = pose_vi_lm_cuda.twin_gaps(got, ref)
    assert all(v <= 1 for v in gaps.values()), gaps


@pytest.mark.card
@pytest.mark.parametrize("compute_marg", [False, True])
@pytest.mark.parametrize("stereo", [False, True])
def test_kernel_matches_twin_on_the_card(cuda, stereo, compute_marg):
    """At the tracker's shapes; bf as the stereo system passes it, a 0-d
    tensor on the card; the counter rises by one."""
    args, kw, Pt = problem(4, 1024, 16384, stereo, device=cuda)
    if stereo:
        kw["bf"] = torch.tensor(BF, device=cuda)
    n0 = pose_vi_lm_cuda.LIB.launches
    got = ba_vi.pose_only_vi(*args, **kw, compute_marg=compute_marg)
    torch.cuda.synchronize()
    assert pose_vi_lm_cuda.LIB.launches == n0 + 1
    _assert_close(got, ba_vi.pose_only_vi_ref(*args, **kw, compute_marg=compute_marg))
    assert np.abs(got[0].P.cpu().numpy() - Pt).max() < 0.01
    assert (float(got[3].abs().max()) > 0) == compute_marg


@pytest.mark.card
@pytest.mark.parametrize("stereo", [False, True])
def test_kernel_matches_twin_with_gross_outliers(cuda, stereo):
    """Half the rows gross outliers: the robust weights and the truncation
    decide the solve, in both."""
    args, kw, _ = problem(5, 1024, 16384, stereo, outliers=0.5, device=cuda)
    _assert_close(ba_vi.pose_only_vi(*args, **kw), ba_vi.pose_only_vi_ref(*args, **kw))


@pytest.mark.card
def test_kernel_keeps_the_state_when_cholesky_fails(cuda):
    """Every candidate rejected: the start is kept (the kernel's Gram-Schmidt
    rounds apart from PyTorch's norms)."""
    args, kw, _ = problem(6, 1024, 16384, False, fail=True, device=cuda)
    ns, _, _, _ = ba_vi.pose_only_vi(*args, **kw)
    cur0 = args[0]
    for f in ("P", "V", "bg", "ba", "dbg", "dba"):
        assert torch.equal(getattr(ns, f), getattr(cur0, f)), f
    torch.testing.assert_close(ns.R, lie.so3_normalize_fast(cur0.R), rtol=0, atol=1e-6)


@pytest.mark.card
@pytest.mark.parametrize("stereo", [False, True])
def test_kernel_is_deterministic_and_counted(cuda, stereo):
    """Two launches give the same bits; the counter rises by one a call;
    rtol > 0 (the early stop) keeps to the twin too."""
    args, kw, _ = problem(7, 1024, 16384, stereo, device=cuda)
    n0 = pose_vi_lm_cuda.LIB.launches
    a = ba_vi.pose_only_vi(*args, **kw)
    b = ba_vi.pose_only_vi(*args, **kw)
    torch.cuda.synchronize()
    assert pose_vi_lm_cuda.LIB.launches == n0 + 2
    for x, y in zip(a[0] + a[1:], b[0] + b[1:]):
        assert torch.equal(x, y)
    kw = dict(kw, rtol=1e-3)
    _assert_close(ba_vi.pose_only_vi(*args, **kw), ba_vi.pose_only_vi_ref(*args, **kw))
    assert pose_vi_lm_cuda.LIB.launches == n0 + 3


@pytest.mark.card
def test_kernel_takes_views_as_their_values(cuda):
    """Views the twin takes (a strided position, a transposed-back
    information) give the bits of their contiguous copies."""
    args, kw, _ = problem(8, 1024, 16384, False, device=cuda)
    cur0, prior = args[0], args[8]
    P_view = torch.stack([cur0.P, cur0.P], 1)[:, 0]
    info_view = prior.info.T.contiguous().T
    assert not P_view.is_contiguous() and not info_view.is_contiguous()
    views = list(args)
    views[0] = cur0._replace(P=P_view)
    views[8] = prior._replace(info=info_view)
    a = ba_vi.pose_only_vi(*views, **kw)
    b = ba_vi.pose_only_vi(*args, **kw)
    for x, y in zip(a[0] + a[1:], b[0] + b[1:]):
        assert torch.equal(x, y)


@pytest.mark.card
@pytest.mark.parametrize("stereo", [False, True])
def test_kernel_takes_the_robust_policy_from_python(cuda, stereo, monkeypatch):
    """The gates (ba.CHI2_MONO / CHI2_STEREO) and the truncation
    (lm.HUBER_TRUNC) reach the kernel at launch: with other values both the
    kernel and its twin move, and they still agree."""
    args, kw, _ = problem(9, 1024, 16384, stereo, device=cuda)
    before = ba_vi.pose_only_vi(*args, **kw)
    monkeypatch.setattr(ba, "CHI2_MONO", 3.0)
    monkeypatch.setattr(ba, "CHI2_STEREO", 5.0)
    monkeypatch.setattr(lm, "HUBER_TRUNC", 100.0)
    got = ba_vi.pose_only_vi(*args, **kw)
    _assert_close(got, ba_vi.pose_only_vi_ref(*args, **kw))
    assert not torch.equal(got[2], before[2])
