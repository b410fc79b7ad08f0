"""Parity of the port's local-mapping stage functions with the JAX package,
each on the same MapState: the small track-and-map run's map right after its
second keyframe insertion (3 keyframes, ~150 points, 256 features; see
torch_port_helpers.SMALL), converted field by field.

Integer tables (kf_mp, mp_active, mp_ref_kf, mp_first_kf, descriptors, the
chosen slots and neighbour lists) must be exactly equal. Float tables agree
to 1e-4: new points come out of a float32 4x4 SVD and normals / distance
bands are computed from them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.imu.preintegration import preint_identity as j_preint_identity
from mc_slam_tpu.pipeline import mapping as jmap
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.imu.preintegration import PreintState
from mc_slam_tpu_torch.pipeline import mapping as tmap

from torch_port_helpers import (SMALL, assert_maps_match, jax_cam, jax_ext, jax_map,
                                small_run, torch_map)

torch.set_num_threads(2)
i32 = lambda v: jnp.asarray(v, jnp.int32)


@pytest.fixture(scope="module")
def scene():
    seq, cam, ext, res, captured = small_run()
    tm, st, frame = captured[1]
    assert st.kf_slots == [0, 1, 2] and frame == 20
    return dict(tm=tm, jm=jax_map(tm), cam=cam, ext=ext, jcam=jax_cam(cam), jext=jax_ext())


def _with_counters(tm, rng):
    """Random found / visible counters so that the ratio rule has work."""
    vis = torch.from_numpy(rng.integers(0, 9, tm.P).astype(np.float32))
    found = torch.floor(vis * torch.from_numpy(rng.random(tm.P).astype(np.float32)))
    return tm._replace(mp_visible=vis, mp_found=found)


@pytest.mark.parametrize("current_id,min_obs", [(13, 3), (22, 2), (24, 3)])
def test_cull_map_points(scene, current_id, min_obs):
    tm = _with_counters(scene["tm"], np.random.default_rng(current_id))
    jm2, nj = jmap.cull_map_points(jax_map(tm), i32(current_id), min_obs)
    tm2, nt = tmap.cull_map_points(tm, current_id, min_obs)
    assert int(nt) == int(nj) and int(nj) > 0
    assert_maps_match(jm2, tm2)


def test_cull_orphans(scene):
    tm = scene["tm"]
    jm2, nj = jmap.cull_orphans(scene["jm"], i32(60))
    tm2, nt = tmap.cull_orphans(tm, 60)
    assert int(nt) == int(nj) and int(nj) > 0
    assert_maps_match(jm2, tm2)


@pytest.mark.parametrize("full", [False, True])
def test_evict_low_value_ties_and_full_table(scene, full):
    """Most points tie on (observations, found/visible): the stable sort must
    pick the same slots. full: every slot of the point table active."""
    tm = scene["tm"]
    if full:
        tm = tm._replace(mp_active=torch.ones_like(tm.mp_active))
    jm2, nj = jmap.evict_low_value(jax_map(tm), i32(100), 32)
    tm2, nt = tmap.evict_low_value(tm, 100, 32)
    assert int(nt) == int(nj) == 32
    assert_maps_match(jm2, tm2)


@pytest.mark.parametrize("occupancy", [0.5, 0.93, 0.99])
def test_cull_and_evict_branches(scene, occupancy):
    """Below 90 % nothing but the cull runs; above it the orphan sweep; above
    95 % the eviction too. The port selects by mask what lax.cond branches on."""
    tm = scene["tm"]
    active = tm.mp_active.clone()
    active[:int(occupancy * tm.P)] = True
    tm = tm._replace(mp_active=active)
    jm2 = jmap.cull_and_evict(jax_map(tm), i32(100), min_obs=3, n_evict=71)
    tm2 = tmap.cull_and_evict(tm, 100, min_obs=3, n_evict=71)
    assert_maps_match(jm2, tm2)
    n0, n1 = int(tm.mp_active.sum()), int(tm2.mp_active.sum())
    assert (n1 < n0) == (occupancy > 0.9)


@pytest.mark.parametrize("kf_a,kf_b", [(2, 1), (2, 0), (1, 2), (2, 2)])
def test_create_points_with_neighbor(scene, kf_a, kf_b):
    jm2, nj = jmap.create_points_with_neighbor(
        scene["jm"], i32(kf_a), i32(kf_b), scene["jcam"], scene["jext"], max_new=64,
        n_levels=SMALL.n_levels)
    tm2, nt = tmap.create_points_with_neighbor(
        scene["tm"], kf_a, torch.tensor([kf_b]), scene["cam"], scene["ext"], max_new=64,
        n_levels=SMALL.n_levels)
    assert int(nt) == int(nj)
    if (kf_a, kf_b) == (2, 1):
        assert int(nj) >= 5
    if kf_a == kf_b:
        assert int(nj) == 0          # a self-pair (padding) has no baseline
    assert_maps_match(jm2, tm2, rtol=1e-4, atol=1e-4)


def test_create_points_with_full_table(scene):
    tm = scene["tm"]._replace(mp_active=torch.ones_like(scene["tm"].mp_active))
    jm2, nj = jmap.create_points_with_neighbor(
        jax_map(tm), i32(2), i32(1), scene["jcam"], scene["jext"], max_new=64,
        n_levels=SMALL.n_levels)
    tm2, nt = tmap.create_points_with_neighbor(
        tm, 2, 1, scene["cam"], scene["ext"], max_new=64, n_levels=SMALL.n_levels)
    assert int(nt) == int(nj) == 0
    assert_maps_match(jm2, tm2)


def test_create_points_scan_chains_the_map(scene):
    nbrs = [1, 0, 2, 2]
    jm2, nj = jmap.create_points_with_neighbors(
        scene["jm"], i32(2), i32(nbrs), scene["jcam"], scene["jext"], max_new=64,
        n_levels=SMALL.n_levels)
    tm2, nt = tmap.create_points_with_neighbors(
        scene["tm"], 2, torch.tensor(nbrs), scene["cam"], scene["ext"], max_new=64,
        n_levels=SMALL.n_levels)
    assert int(nt) == int(nj) > 0
    assert_maps_match(jm2, tm2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("src,dst", [(1, 2), (2, 1), (0, 2)])
def test_fuse_into_keyframe(scene, src, dst):
    jm2, nj = jmap.fuse_into_keyframe(scene["jm"], i32(src), i32(dst), scene["jcam"],
                                      scene["jext"])
    tm2, nt = tmap.fuse_into_keyframe(scene["tm"], torch.tensor(src), dst, scene["cam"],
                                      scene["ext"])
    assert int(nt) == int(nj)
    assert_maps_match(jm2, tm2)


def test_fuse_neighbors_round(scene):
    nb, nbv = [1, 0, 2, 2], [1.0, 1.0, 0.0, 0.0]
    jm2, nj = jmap.fuse_neighbors(scene["jm"], i32(2), i32(nb), jnp.asarray(nbv),
                                  scene["jcam"], scene["jext"])
    tm2, nt = tmap.fuse_neighbors(scene["tm"], 2, torch.tensor(nb), torch.tensor(nbv),
                                  scene["cam"], scene["ext"])
    assert int(nt) == int(nj) > 0
    assert_maps_match(jm2, tm2)


def _tied_map(tm):
    """Slots 3 and 4 become copies of keyframe 1's association row: three
    neighbours of slot 2 with exactly equal covisibility weights."""
    kf_mp, fv, act = tm.kf_mp.clone(), tm.kf_feat_valid.clone(), tm.kf_active.clone()
    for s in (3, 4):
        kf_mp[s], fv[s], act[s] = tm.kf_mp[1], tm.kf_feat_valid[1], True
    return tm._replace(kf_mp=kf_mp, kf_feat_valid=fv, kf_active=act)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("covis_th", [15, 500])
def test_kf_neighbors(scene, tied, covis_th):
    tm = _tied_map(scene["tm"]) if tied else scene["tm"]
    ref = jmap.kf_neighbors(jax_map(tm), i32(2), covis_th=covis_th)
    got = tmap.kf_neighbors(tm, 2, covis_th=covis_th)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if tied and covis_th == 15:
        assert got[0].tolist() == [0, 1, 3, 4]        # equal weights: lowest slot first


def test_refresh_point_stats(scene):
    tm = _tied_map(scene["tm"])
    _, _, wslots, wvalid = tmap.kf_neighbors(tm, 2)
    jm2 = jmap.refresh_point_stats(jax_map(tm), i32(wslots.numpy()),
                                   jnp.asarray(wvalid.numpy()), scene["jext"],
                                   n_levels=SMALL.n_levels)
    tm2 = tmap.refresh_point_stats(tm, wslots, wvalid, scene["ext"], n_levels=SMALL.n_levels)
    assert_maps_match(jm2, tm2, rtol=1e-5, atol=1e-5)
    assert (tm2.mp_normal != tm.mp_normal).any()


def test_event_stats_and_redundancy(scene):
    tm, jm = scene["tm"], scene["jm"]
    for a, b in zip(jmap.kf_event_stats(jm, i32(2), min_obs=3),
                    tmap.kf_event_stats(tm, 2, min_obs=3)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for a, b in zip(jmap.kf_redundancy_all(jm), tmap.kf_redundancy_all(tm)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for a, b in zip(jmap.kf_redundancy(jm, i32(1)), tmap.kf_redundancy(tm, torch.tensor(1))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_write_keyframe_with_associations_and_preintegration(scene):
    tm, jm = scene["tm"], scene["jm"]
    rng = np.random.default_rng(3)
    F = tm.F
    feat_mp = np.where(rng.random(F) < 0.5, rng.integers(0, tm.P, F), -1).astype(np.int32)
    pre = jax.tree_util.tree_map(np.asarray, j_preint_identity())
    pre = pre._replace(dP=rng.normal(size=3).astype(np.float32), dT=np.float32(0.5),
                       cov=np.eye(9, dtype=np.float32) * 1e-4)
    rows = [np.asarray(x) for x in (
        jm.kf_ns.P[1], jm.kf_ns.R[1], jm.kf_ns.V[1], jm.kf_ns.bg[1], jm.kf_ns.ba[1],
        np.float32(2.5), np.int32(50), jm.kf_uv[1], jm.kf_level[1], jm.kf_angle[1],
        jm.kf_ur[1], jm.kf_desc[1], jm.kf_pm1[1], jm.kf_feat_valid[1])]
    jm2 = jmap.write_keyframe(jm, i32(3), *[jnp.asarray(a) for a in rows],
                              feat_mp=jnp.asarray(feat_mp), pre=pre)
    tm2 = tmap.write_keyframe(tm, 3, *[convert._tensor(a, "cpu") for a in rows],
                              feat_mp=torch.from_numpy(feat_mp),
                              pre=convert.to_torch(PreintState, pre, "cpu"))
    assert_maps_match(jm2, tm2, rtol=0, atol=0)
    assert np.asarray(jm2.kf_preint.dT)[3] == 0.5 and tm2.kf_mp[3].tolist() == feat_mp.tolist()


def test_prune_deactivate_and_counters(scene):
    tm, jm = scene["tm"], scene["jm"]
    rng = np.random.default_rng(4)
    ks = np.array([2, 0], np.int32)
    chi2 = rng.uniform(0, 20, 2 * tm.F).astype(np.float32)
    valid = (rng.random(2 * tm.F) < 0.8).astype(np.float32)
    assert_maps_match(
        jmap.prune_associations(jm, jnp.asarray(ks), jnp.asarray(chi2), jnp.asarray(valid), 5.991),
        tmap.prune_associations(tm, torch.from_numpy(ks), torch.from_numpy(chi2),
                                torch.from_numpy(valid), 5.991))
    assert_maps_match(jmap.deactivate_keyframe(jm, i32(1)), tmap.deactivate_keyframe(tm, 1))
    assert_maps_match(jmap.deactivate_keyframe(jm, i32(1)),
                      tmap.deactivate_keyframe(tm, torch.tensor(1)))
    vis, found = rng.random(tm.P) < 0.5, rng.random(tm.P) < 0.3
    assert_maps_match(
        jmap.update_found_visible(jm, jnp.asarray(vis), jnp.asarray(found)),
        tmap.update_found_visible(tm, torch.from_numpy(vis), torch.from_numpy(found)))
