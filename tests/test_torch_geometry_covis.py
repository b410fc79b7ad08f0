"""Parity of the port's triangulation and covisibility functions with the JAX
package, and the port's device default.

Tolerances: triangulated points 1e-3 relative to their depth (both sides take
the null vector of a float32 4x4 SVD, whose smallest singular vector is
determined to ~1e-4 of the scene scale at this parallax); depths alike;
parallax cosines 1e-6; covisibility and observation counts are sums of 0/1
floats and must be exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.geometry import triangulation as jtri
from mc_slam_tpu.slam_map import mapstate as jms
from mc_slam_tpu_torch import camera as tcam, convert, device as tdevice
from mc_slam_tpu_torch.geometry import triangulation as ttri
from mc_slam_tpu_torch.imu import navstate as tnav, preintegration as tpre
from mc_slam_tpu_torch.slam_map import mapstate as tms
from mc_slam_tpu_torch.solver import factors as tfac

from test_geometry import two_view_scene
from torch_port_helpers import torch_map

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


@pytest.mark.parametrize("planar", [False, True])
def test_triangulate_two_view_matches_jax(planar):
    rng = np.random.default_rng(3)
    xn0, xn1, vis, pts, R1, C1 = two_view_scene(rng, n=300, planar=planar)
    I3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    Xj, d0j, d1j = jtri.triangulate_two_view(jnp.asarray(I3), jnp.asarray(z3),
                                             jnp.asarray(R1), jnp.asarray(C1), xn0, xn1)
    Xt, d0t, d1t = ttri.triangulate_two_view(_t(I3), _t(z3), _t(R1), _t(C1),
                                             _t(xn0), _t(xn1))
    depth = np.abs(np.asarray(d0j))[:, None]
    assert np.max(np.abs(Xt.numpy() - np.asarray(Xj)) / np.maximum(depth, 1.0)) < 1e-3
    np.testing.assert_allclose(d0t.numpy(), np.asarray(d0j), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(d1t.numpy(), np.asarray(d1j), rtol=1e-3, atol=1e-3)
    # and against the truth, as the JAX package's own test does
    ok = np.asarray(vis) > 0
    assert np.median(np.linalg.norm(Xt.numpy() - pts, axis=1)[ok]) < 0.1
    cj = jtri.parallax_cos(jnp.asarray(z3), jnp.asarray(C1), Xj)
    ct = ttri.parallax_cos(_t(z3), _t(C1), _t(np.asarray(Xj)))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)


def test_triangulation_batches_over_leading_dims():
    rng = np.random.default_rng(4)
    xn0, xn1, _, _, R1, C1 = two_view_scene(rng, n=24)
    a = ttri.triangulate_two_view(torch.eye(3), torch.zeros(3), _t(R1), _t(C1),
                                  _t(xn0), _t(xn1))
    b = ttri.triangulate_two_view(torch.eye(3), torch.zeros(3), _t(R1), _t(C1),
                                  _t(xn0).reshape(4, 6, 2), _t(xn1).reshape(4, 6, 2))
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy().reshape(v.shape), v.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _random_map(rng, K=8, P=96, F=40):
    """A JAX MapState with random associations: inactive keyframes, inactive
    points, invalid features and one keyframe holding a point twice."""
    jm = jax.tree_util.tree_map(np.array, jms.empty_map(K, P, F))
    kf_mp = np.where(rng.random((K, F)) < 0.6, rng.integers(0, P, (K, F)), -1)
    kf_mp[2, 0] = kf_mp[2, 1] = 5              # one point in two features
    return jm._replace(
        kf_mp=kf_mp.astype(np.int32),
        kf_feat_valid=rng.random((K, F)) < 0.9,
        kf_active=np.array([True] * (K - 2) + [False, True]),
        mp_active=rng.random(P) < 0.85)


@pytest.mark.parametrize("fn", ["covisibility_weights", "covisibility_matrix",
                                "observation_counts"])
def test_covisibility_and_counts_exact(fn):
    jm = _random_map(np.random.default_rng(5))
    tm = torch_map(jm)
    if fn == "covisibility_weights":
        for slot in (0, 2, 6):
            ref = np.asarray(jms.covisibility_weights(jm, slot))
            np.testing.assert_array_equal(tms.covisibility_weights(tm, slot).numpy(), ref)
            np.testing.assert_array_equal(
                tms.covisibility_weights(tm, torch.tensor(slot)).numpy(), ref)
    else:
        ref = np.asarray(getattr(jms, fn)(jm))
        np.testing.assert_array_equal(getattr(tms, fn)(tm).numpy(), ref)


CONSTRUCTORS = {
    "empty_map": lambda **kw: tms.empty_map(2, 4, 3, **kw).mp_pos,
    "make_camera": lambda **kw: tcam.make_camera(1.0, 1.0, 0.0, 0.0, **kw).fx,
    "euroc_camera": lambda **kw: tcam.euroc_camera(**kw).fx,
    "extrinsics_from_Tbc": lambda **kw: tfac.extrinsics_from_Tbc(np.eye(4), **kw).Rcb,
    "euroc_noise": lambda **kw: tpre.euroc_noise(**kw).sigma_g,
    "preint_identity": lambda **kw: tpre.preint_identity((2,), **kw).dP,
    "navstate_identity": lambda **kw: tnav.navstate_identity((2,), **kw).P,
    "to_torch": lambda **kw: convert.to_torch(
        tnav.NavState, {f: np.zeros(3, np.float32) for f in tnav.NavState._fields},
        **kw).P,
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_device_default(name):
    """No device means the card: on a host without one the constructor raises
    (no quiet CPU); with device="cpu" it builds on the CPU."""
    make = CONSTRUCTORS[name]
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def test_resolve():
    assert tdevice.resolve(None) == torch.device("cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tdevice.resolve(torch.device("cuda", 0)) == torch.device("cuda", 0)
