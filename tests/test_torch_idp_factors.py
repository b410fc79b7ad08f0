"""Parity of the inverse-depth reprojection factor and of the Schur engine
(build_landmark_system, schur_solve, schur_solve_pr) with the JAX package.

Tolerances: residuals and Jacobians 1e-5 relative (the same float32 formulas,
other summation order inside the 3x3 products); the analytic Jacobians once
more against central differences in float64 (1e-6 relative). The assembled
normal equations are sums of ~10^3 float32 products accumulated in another
order (XLA einsum vs index_add / matmul), so their blocks agree to 2e-4 of
the largest entry; the solves to 2e-3 relative to the step's size, and the
port's solve to 1e-8 against a dense float64 solve of the same system."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.camera import euroc_camera as j_euroc
from mc_slam_tpu.solver import factors as jfac, lm as jlm
from mc_slam_tpu_torch import lie as tlie
from mc_slam_tpu_torch.camera import euroc_camera as t_euroc
from mc_slam_tpu_torch.solver import factors as tfac, lm as tlm

from test_torch_solver import TBC

torch.set_num_threads(2)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rot(rng, n, scale=0.3):
    return tlie.so3_exp(_t(rng.normal(size=(n, 3)) * scale, torch.float64)).numpy()


def _idp_inputs(rng, n=64):
    """Anchor / observer poses looking roughly down +z of the camera, landmarks
    2-8 m in front of the anchor camera."""
    R0 = _rot(rng, n, 0.05)
    Ri = _rot(rng, n, 0.05)
    P0 = rng.normal(size=(n, 3)) * 0.1
    Pi = P0 + rng.normal(size=(n, 3)) * 0.3
    rho = 1.0 / rng.uniform(2.0, 8.0, n)
    uv0 = np.stack([rng.uniform(50, 700, n), rng.uniform(50, 430, n)], -1)
    uv = np.stack([rng.uniform(50, 700, n), rng.uniform(50, 430, n)], -1)
    return dict(rho=rho, uv0=uv0, P0=P0, R0=R0, Pi=Pi, Ri=Ri, uv=uv)


def test_reproj_idp_matches_jax():
    s = _idp_inputs(np.random.default_rng(0))
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    out_j = jfac.reproj_idp(j_euroc(), jfac.extrinsics_from_Tbc(TBC), f32(s["rho"]),
                            f32(s["uv0"]), f32(s["P0"]), f32(s["R0"]), f32(s["Pi"]),
                            f32(s["Ri"]), f32(s["uv"]))
    out_t = tfac.reproj_idp(t_euroc(device="cpu"), tfac.extrinsics_from_Tbc(TBC, device="cpu"),
                            _t(s["rho"]), _t(s["uv0"]), _t(s["P0"]), _t(s["R0"]),
                            _t(s["Pi"]), _t(s["Ri"]), _t(s["uv"]))
    for name, a, b in zip(("r", "J_rho", "J_pr0", "J_pri", "z"), out_j, out_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)


def test_reproj_idp_jacobians_against_finite_differences():
    s = _idp_inputs(np.random.default_rng(1), n=16)
    d = torch.float64
    cam = t_euroc(dtype=d, device="cpu")
    ext = tfac.extrinsics_from_Tbc(TBC, dtype=d, device="cpu")
    a = {k: _t(v, d) for k, v in s.items()}

    def res(rho, P0, R0, Pi, Ri):
        return tfac.reproj_idp(cam, ext, rho, a["uv0"], P0, R0, Pi, Ri, a["uv"])[0]

    _, J_rho, J_pr0, J_pri, _ = tfac.reproj_idp(cam, ext, a["rho"], a["uv0"], a["P0"],
                                                a["R0"], a["Pi"], a["Ri"], a["uv"])
    base = (a["rho"], a["P0"], a["R0"], a["Pi"], a["Ri"])
    h = 1e-6

    def central(perturb):
        return (res(*perturb(+h)) - res(*perturb(-h))) / (2 * h)

    num_rho = central(lambda e: (base[0] + e, *base[1:]))
    np.testing.assert_allclose(J_rho[..., 0].numpy(), num_rho.numpy(), rtol=1e-6, atol=1e-5)
    for col in range(3):
        e3 = torch.zeros(3, dtype=d)
        e3[col] = 1.0
        # retraction: P <- P + dP, R <- R Exp(dphi)
        n_P0 = central(lambda e: (base[0], base[1] + e * e3, *base[2:]))
        n_f0 = central(lambda e: (base[0], base[1], base[2] @ tlie.so3_exp(e * e3),
                                  base[3], base[4]))
        n_Pi = central(lambda e: (*base[:3], base[3] + e * e3, base[4]))
        n_fi = central(lambda e: (*base[:4], base[4] @ tlie.so3_exp(e * e3)))
        for J, num, c in ((J_pr0, n_P0, col), (J_pr0, n_f0, 3 + col),
                          (J_pri, n_Pi, col), (J_pri, n_fi, 3 + col)):
            np.testing.assert_allclose(J[..., c].numpy(), num.numpy(), rtol=1e-6,
                                       atol=1e-4)


def _random_system(rng, K, DP, DC=6, Nc=5, Np=40, O=300, R=2):
    cam = rng.integers(0, Nc, (O, K)).astype(np.int32)
    pt = rng.integers(0, Np - 3, O).astype(np.int32)     # the last 3 landmarks unseen
    Jc = rng.normal(size=(O, K, R, DC)).astype(np.float32)
    Jp = rng.normal(size=(O, R, DP)).astype(np.float32)
    r = rng.normal(size=(O, R)).astype(np.float32)
    w = (rng.uniform(0.2, 1.0, O) * (rng.random(O) < 0.9)).astype(np.float32)
    free = np.ones(Nc, np.float32)
    free[0] = 0.0
    return dict(cam=cam, pt=pt, Jc=Jc, Jp=Jp, r=r, w=w), free, (Nc, DC, Np, DP)


def _systems(rng, K, DP):
    o, free, dims = _random_system(rng, K, DP)
    sj = jlm.build_landmark_system(jlm.Observations(**{k: jnp.asarray(v) for k, v in o.items()}),
                                   jnp.asarray(free), *dims)
    ot = tlm.Observations(cam=_t(o["cam"], torch.int64), pt=_t(o["pt"], torch.int64),
                          Jc=_t(o["Jc"]), Jp=_t(o["Jp"]), r=_t(o["r"]), w=_t(o["w"]))
    st = tlm.build_landmark_system(ot, _t(free), *dims)
    return sj, st, free, dims


@pytest.mark.parametrize("K,DP", [(2, 1), (1, 3)])
def test_build_landmark_system_matches_jax(K, DP):
    sj, st, _, _ = _systems(np.random.default_rng(2), K, DP)
    for name, a, b in zip(("Hcc", "g_c", "Hpp", "g_p", "Wcp", "cost"), sj, st):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=2e-4 * np.abs(a).max(),
                                   err_msg=name)


@pytest.mark.parametrize("K,DP", [(2, 1), (1, 3)])
def test_schur_solve_matches_jax_and_dense(K, DP):
    sj, st, free, (Nc, DC, Np, DP) = _systems(np.random.default_rng(3), K, DP)
    pt_mask = np.ones(Np, np.float32)
    pt_mask[-3:] = 0.0
    lam = 1e-3
    dxc_j, dxp_j = jlm.schur_solve(*sj[:5], lam, jnp.asarray(free), jnp.asarray(pt_mask))
    dxc_t, dxp_t = tlm.schur_solve(*st[:5], torch.tensor(lam), _t(free), _t(pt_mask))
    for a, b in ((dxc_j, dxc_t), (dxp_j, dxp_t)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=2e-3 * np.abs(a).max())

    # dense float64 solve of the port's own damped system
    Hcc, g_c, Hpp, g_p, Wcp = (x.to(torch.float64) for x in st[:5])
    Hpp_d = tlm.damp_point_blocks(Hpp, torch.tensor(lam, dtype=torch.float64))
    n, npd = Nc * DC, Np * DP
    A = torch.zeros((n + npd, n + npd), dtype=torch.float64)
    Hc = Hcc.reshape(n, n)
    A[:n, :n] = Hc + torch.diag(lam * torch.diagonal(Hc) + 1e-10)
    A[:n, n:] = Wcp.reshape(n, npd)
    A[n:, :n] = Wcp.reshape(n, npd).T
    A[n:, n:] = torch.block_diag(*Hpp_d)
    b = -torch.cat([g_c.reshape(n), g_p.reshape(npd)])
    fm = torch.cat([_t(free, torch.float64).repeat_interleave(DC), torch.ones(npd, dtype=torch.float64)])
    A = A * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    x = torch.linalg.solve(A, b * fm)
    dxc64, dxp64 = tlm.schur_solve(Hcc, g_c, Hpp, g_p, Wcp,
                                   torch.tensor(lam, dtype=torch.float64),
                                   _t(free, torch.float64), torch.ones(Np, dtype=torch.float64))
    np.testing.assert_allclose(dxc64.reshape(-1).numpy(), x[:n].numpy(), rtol=0,
                               atol=1e-8 * float(x.abs().max()))
    np.testing.assert_allclose(dxp64.reshape(-1).numpy(), x[n:].numpy(), rtol=0,
                               atol=1e-8 * float(x.abs().max()))


def test_schur_solve_pr_matches_jax_and_full_form():
    """The pose-only-coupling form: visual 6-d blocks embedded in a 15-d camera
    system, against the JAX function and against schur_solve on the same
    system with Wcp zero-padded to 15 rows."""
    rng = np.random.default_rng(4)
    sj, st, free, (Nc, Dv, Np, DP) = _systems(rng, 2, 1)
    DC = 15
    A = rng.normal(size=(Nc * DC, Nc * DC)).astype(np.float32)
    H15 = (A @ A.T + 50 * np.eye(Nc * DC, dtype=np.float32)).reshape(Nc, DC, Nc, DC)
    g15 = rng.normal(size=(Nc, DC)).astype(np.float32)
    H15[:, :Dv, :, :Dv] += np.asarray(sj[0])
    g15[:, :Dv] += np.asarray(sj[1])
    pt_mask = np.ones(Np, np.float32)
    lam = 1e-4
    dxc_j, dxp_j = jlm.schur_solve_pr(jnp.asarray(H15), jnp.asarray(g15), sj[2], sj[3],
                                      sj[4], lam, jnp.asarray(free), jnp.asarray(pt_mask))
    Hpp, g_p, Wcp = (_t(np.asarray(x)) for x in sj[2:5])     # the same blocks on both sides
    dxc_t, dxp_t = tlm.schur_solve_pr(_t(H15), _t(g15), Hpp, g_p, Wcp, torch.tensor(lam),
                                      _t(free), _t(pt_mask))
    for a, b in ((dxc_j, dxc_t), (dxp_j, dxp_t)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=2e-3 * np.abs(a).max())
    Wfull = torch.zeros((Nc, DC, Np, DP))
    Wfull[:, :Dv] = Wcp
    dxc_f, dxp_f = tlm.schur_solve(_t(H15), _t(g15), Hpp, g_p, Wfull, torch.tensor(lam),
                                   _t(free), _t(pt_mask))
    np.testing.assert_allclose(dxc_t.numpy(), dxc_f.numpy(), rtol=0,
                               atol=1e-4 * float(dxc_f.abs().max()))
    np.testing.assert_allclose(dxp_t.numpy(), dxp_f.numpy(), rtol=0,
                               atol=1e-4 * float(dxp_f.abs().max()))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_batched_inv_small_and_damping(d):
    rng = np.random.default_rng(5 + d)
    A = rng.normal(size=(50, d, d)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(d, dtype=np.float32)
    inv_t = tlm.batched_inv_small(_t(H)).numpy()
    np.testing.assert_allclose(inv_t, np.asarray(jlm.batched_inv_small(jnp.asarray(H))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(inv_t @ H, np.broadcast_to(np.eye(d), H.shape), atol=1e-4)
    H[-5:] = 0.0                                   # unobserved landmarks
    np.testing.assert_allclose(
        tlm.damp_point_blocks(_t(H), torch.tensor(0.25)).numpy(),
        np.asarray(jlm.damp_point_blocks(jnp.asarray(H), 0.25)), rtol=1e-6, atol=1e-7)
