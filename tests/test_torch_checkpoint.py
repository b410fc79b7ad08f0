"""Checkpoint and resume of the port (mc_slam_tpu_torch/io/checkpoint.py)
against the JAX package's file layout, both ways, and the pipeline's
mesh-sharded whole-map solvers (`enable_mesh`) on the same cached map.

The state is `torch_port_helpers.boot_run()`'s bootstrapped system (VI
initialized, 480x360, K = 16, P = 2048, F = 512); the JAX side is a
SlamSystem in parity mode (`jax_system_from_port`). Every map table must come
back bit-equal, every extra key equal. The resume case repeats the JAX
oracle tests/test_aux.py::test_checkpoint_resume on the port."""
import copy
import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.io import checkpoint as jckpt
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.io import checkpoint
from mc_slam_tpu_torch.parallel import dist_ba
from mc_slam_tpu_torch.pipeline import loopclosing, mapping_ctl
from mc_slam_tpu_torch.pipeline.pipebase import OK
from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
from render import DotWorld
from torch_port_helpers import boot_run, jax_system_from_port

EXTRA_KEYS = ("frame_id", "n_kf", "last_kf_slot", "last_kf_frame", "kf_slots", "vi_inited",
              "gw", "first_kf_time", "state", "kf_imu_raw", "bow_hists_nonzero", "loop_edges",
              "n_loops_closed", "broken_chain_slots", "free_slots", "next_fresh_slot",
              "hist_ids")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _flat(m):
    """A MapState (port tensors or JAX arrays) as {field: numpy}, flattened
    as the file stores it."""
    if isinstance(m.mp_pos, torch.Tensor):
        d = convert.to_numpy(m)
    else:
        d = {f: (np.asarray(v) if not hasattr(v, "_fields") else
                 {g: np.asarray(x) for g, x in v._asdict().items()})
             for f, v in m._asdict().items()}
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update({f"{k}.{g}": x for g, x in v.items()})
        else:
            out[k] = v
    return out


def _assert_maps_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _extra(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__extra__"]).decode())


def _mirrors(slam):
    """The host mirrors of kf_time / kf_id as a load rebuilds them (from the
    map's tables, so times are the float32 values)."""
    t, i = slam.m.kf_time.numpy(), slam.m.kf_id.numpy()
    return ({s: float(t[s]) for s in slam.st.kf_slots},
            {s: int(i[s]) for s in slam.st.kf_slots})


def _fresh(slam):
    return SlamSystem(slam.cam, dataclasses.replace(slam.cfg), Tbc=slam._Tbc, device="cpu")


def _jax_twin(monkeypatch, slam):
    """A JAX SlamSystem holding the port system's state and detector."""
    js = jax_system_from_port(monkeypatch, slam.cam, slam.m, slam.st, frame_id=slam.frame_id)
    d = convert.detector_to_dict(slam.loop)
    js.loop.hists = jnp.asarray(d["hists"])
    js.loop.vocab = jnp.asarray(d["vocab"])
    js.loop.hist_ids = d["hist_ids"]
    js.gw = jnp.asarray(slam.gw.numpy())
    return js


def test_port_checkpoint_loads_in_jax(tmp_path, monkeypatch):
    """The port saves; the JAX load_system restores it into a JAX SlamSystem:
    every table bit-equal, every extra key equal, the BoW side file too."""
    _, _, _, res, _ = boot_run()
    slam = res["slam"]
    path = str(tmp_path / "port.npz")
    checkpoint.save_system(path, slam)
    extra = _extra(path)
    assert tuple(extra) == EXTRA_KEYS
    js = _jax_twin(monkeypatch, slam)
    js.m = None
    jckpt.load_system(path, js)
    _assert_maps_bit_equal(js.m, slam.m)
    st = slam.st
    assert js.frame_id == slam.frame_id and js.n_kf == st.n_kf
    assert js.kf_slots == st.kf_slots and js.last_kf_slot == st.last_kf_slot
    assert js.last_kf_frame == st.last_kf_frame and js.vi_inited == st.vi_inited
    assert js.first_kf_time == st.first_kf_time and js.state == slam.state == OK
    assert js.free_slots == st.free_slots and js.next_fresh_slot == st.next_fresh_slot
    assert js.broken_chain_slots == st.broken_chain_slots
    assert js.loop_edges == st.loop_edges and js.n_loops_closed == st.n_loops_closed
    assert js.loop.hist_ids == slam.loop.hist_ids
    np.testing.assert_array_equal(np.asarray(js.gw), slam.gw.numpy())
    assert set(js.kf_imu_raw) == set(st.kf_imu_raw)
    for k, rows in st.kf_imu_raw.items():
        np.testing.assert_array_equal(js.kf_imu_raw[k], rows.numpy())
    np.testing.assert_array_equal(np.asarray(js.loop.hists), slam.loop.hists.numpy())
    np.testing.assert_array_equal(np.asarray(js.loop.vocab), slam.loop.vocab.numpy())
    # the host mirrors are rebuilt from the map's float32 / int32 tables
    assert js.kf_time_host == _mirrors(slam)[0] and js.kf_id_host == st.kf_id_host


def test_jax_checkpoint_loads_in_port(tmp_path, monkeypatch):
    """The JAX package saves (the port's state handed over); the port's
    load_system restores it: tables bit-equal to the original port map, the
    host state equal, tracking reseated at the newest keyframe."""
    _, _, _, res, _ = boot_run()
    slam = res["slam"]
    js = _jax_twin(monkeypatch, slam)
    path = str(tmp_path / "jax.npz")
    jckpt.save_system(path, js)
    got = checkpoint.load_system(path, _fresh(slam))
    _assert_maps_bit_equal(got.m, slam.m)
    st, gs = slam.st, got.st
    for f in ("kf_slots", "last_kf_slot", "last_kf_frame", "n_kf", "vi_inited", "first_kf_time",
              "free_slots", "next_fresh_slot", "broken_chain_slots", "loop_edges",
              "n_loops_closed", "kf_id_host", "sensor_depth"):
        assert getattr(gs, f) == getattr(st, f), f
    assert (gs.kf_time_host, gs.kf_id_host) == _mirrors(slam)
    assert set(gs.kf_imu_raw) == set(st.kf_imu_raw)
    for k in st.kf_imu_raw:
        np.testing.assert_array_equal(gs.kf_imu_raw[k].numpy(), st.kf_imu_raw[k].numpy())
    assert got.frame_id == slam.frame_id and got.state == slam.state
    assert got.loop.hist_ids == slam.loop.hist_ids
    np.testing.assert_array_equal(got.loop.hists.numpy(), slam.loop.hists.numpy())
    np.testing.assert_array_equal(got.gw.numpy(), slam.gw.numpy())
    # the reseat: the newest keyframe's pose and NavState, no prior, no
    # velocity model, no trajectory (the JAX file has no .traj.npz)
    k = st.last_kf_slot
    np.testing.assert_array_equal(got.last_pose[0].numpy(), slam.m.kf_ns.P[k].numpy())
    np.testing.assert_array_equal(got.last_ns.V.numpy(), slam.m.kf_ns.V[k].numpy())
    assert got.ts.prior is None and float(got.velocity[0].abs().sum()) == 0.0
    assert got.get_trajectory() == []


def test_port_round_trip_keeps_trajectory(tmp_path):
    """Port to port: tables bit-equal and `get_trajectory()` unchanged."""
    _, _, _, res, _ = boot_run()
    slam = res["slam"]
    path = str(tmp_path / "rt.npz")
    checkpoint.save_system(path, slam)
    got = checkpoint.load_system(path, _fresh(slam))
    _assert_maps_bit_equal(got.m, slam.m)
    a, b = slam.get_trajectory(), got.get_trajectory()
    assert len(a) == len(b) > 90
    for (ta, Pa, Ra), (tb, Pb, Rb) in zip(a, b):
        assert ta == tb
        np.testing.assert_array_equal(Pa, Pb)
        np.testing.assert_array_equal(Ra, Rb)


def test_missing_free_slots_and_hist_ids_are_rebuilt(tmp_path):
    """F7: a file without `free_slots` / `hist_ids` gets them rebuilt: the
    slots below the high-water mark that hold no active keyframe, and each
    active slot's keyframe id. Here slot 3 is taken out of `kf_slots` (as a
    culled keyframe would be) before the two keys are removed."""
    _, _, _, res, _ = boot_run()
    slam = copy.deepcopy(res["slam"])
    slam.st.kf_slots.remove(3)
    slam.st.free_slots = [3]
    path = str(tmp_path / "old.npz")
    checkpoint.save_system(path, slam)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    extra = json.loads(bytes(data["__extra__"]).decode())
    del extra["free_slots"], extra["hist_ids"]
    data["__extra__"] = np.frombuffer(json.dumps(extra).encode(), dtype=np.uint8)
    np.savez_compressed(path, **data)
    got = checkpoint.load_system(path, _fresh(slam))
    assert got.st.free_slots == [3]
    kf_id = slam.m.kf_id.numpy()
    assert got.loop.hist_ids == {s: int(kf_id[s]) for s in slam.st.kf_slots}


def test_capacity_mismatch_raises(tmp_path):
    _, _, _, res, _ = boot_run()
    slam = res["slam"]
    path = str(tmp_path / "cap.npz")
    checkpoint.save_system(path, slam)
    small = SlamSystem(slam.cam, dataclasses.replace(slam.cfg, max_kf=8), device="cpu")
    with pytest.raises(ValueError, match="capacities"):
        checkpoint.load_system(path, small)


def test_mesh_survives_load(tmp_path):
    """A mesh set by `enable_mesh` before a load stays set after it: a resumed
    multi-device run keeps its sharded whole-map BA and pose graph."""
    _, _, _, res, _ = boot_run()
    slam = res["slam"]
    path = str(tmp_path / "mesh.npz")
    checkpoint.save_system(path, slam)
    fresh = _fresh(slam)
    mesh = dist_ba.make_mesh(devices=["cpu"] * 2)
    mesh_e = dist_ba.make_mesh(axis="e", devices=["cpu"] * 2)
    fresh.enable_mesh(mesh, mesh_e)
    got = checkpoint.load_system(path, fresh)
    assert got.mesh is mesh and got.mesh_e is mesh_e
    assert got.st.kf_slots == slam.st.kf_slots


def _dot_pose(t):
    from mc_slam_tpu_torch import lie
    P = np.array([0.8 * np.sin(0.4 * t), 0.15 * np.sin(0.3 * t), 0.05 * t])
    R = lie.so3_exp(torch.tensor([0.0, 0.08 * np.sin(0.5 * t), 0.0])).numpy()
    return P.astype(np.float32), R.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dot_run():
    """tests/test_aux.py::test_checkpoint_resume's system after its first 20
    frames (the dot world, 480x360, no IMU)."""
    torch.set_num_threads(2)
    world = DotWorld(np.random.default_rng(0))
    cam = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360, device="cpu")
    cfg = SlamConfig(max_kf=64, max_mp=2048, n_feat=384, n_levels=3, min_init_matches=50)
    sys1 = SlamSystem(cam, cfg, device="cpu")
    for i in range(20):
        P, R = _dot_pose(i * 0.1)
        sys1.track(world.render(R, P), i * 0.1)
    return world, cam, cfg, sys1


def test_checkpoint_resume(tmp_path):
    """tests/test_aux.py::test_checkpoint_resume on the port: track 20 frames,
    checkpoint, restore into a fresh system, keep tracking: at least 8 of the
    next 10 frames tracked."""
    world, cam, cfg, sys1 = _dot_run()
    assert sys1.state == OK
    ck = str(tmp_path / "map.npz")
    checkpoint.save_system(ck, sys1)
    sys2 = checkpoint.load_system(ck, SlamSystem(cam, cfg, device="cpu"))
    assert sys2.n_kf == sys1.n_kf
    np.testing.assert_array_equal(sys2.m.mp_active.numpy(), sys1.m.mp_active.numpy())
    n_ok = 0
    for i in range(20, 30):
        P, R = _dot_pose(i * 0.1)
        n_ok += int(sys2.track(world.render(R, P), i * 0.1))
    assert n_ok >= 8, n_ok
    assert len(sys2.get_trajectory()) == len(sys1.get_trajectory()) + n_ok


def test_resume_on_a_keyframe_frame_is_exact(tmp_path):
    """A save on the frame of a keyframe event writes `.track.npz`; the system
    loaded with it tracks the next frames to exactly the poses the
    uninterrupted system gives (the reseat is then no seam). Without it (the
    JAX reseat: the last frame's associations dropped) the resumed frames
    still track, to within 5 mm of the uninterrupted ones."""
    world, cam, cfg, sys0 = _dot_run()
    a = copy.deepcopy(sys0)
    i = 20
    while True:
        P, R = _dot_pose(i * 0.1)
        assert a.track(world.render(R, P), i * 0.1)
        i += 1
        if a.last_outcome.keyframe is not None:
            break
        assert i < 45, "no keyframe event"
    path = str(tmp_path / "kf.npz")
    checkpoint.save_system(path, a)
    assert os.path.exists(path + ".track.npz")
    b = checkpoint.load_system(path, SlamSystem(cam, cfg, device="cpu"))
    assert b.ts.has_prev and b.st.ref_tracked == a.st.ref_tracked
    os.remove(path + ".track.npz")
    c = checkpoint.load_system(path, SlamSystem(cam, cfg, device="cpu"))
    assert not c.ts.has_prev
    for k in range(i, i + 5):
        P, R = _dot_pose(k * 0.1)
        img = world.render(R, P)
        assert a.track(img, k * 0.1) and b.track(img, k * 0.1) and c.track(img, k * 0.1)
        np.testing.assert_array_equal(b.ts.P.numpy(), a.ts.P.numpy())
        np.testing.assert_array_equal(b.ts.R.numpy(), a.ts.R.numpy())
        assert float((c.ts.P - a.ts.P).abs().max()) < 5e-3
    # a save between keyframes writes none (and removes a stale one)
    assert a.last_outcome.keyframe is None
    open(path + ".track.npz", "wb").close()
    checkpoint.save_system(path, a)
    assert not os.path.exists(path + ".track.npz")


def test_pipeline_gba_mesh_matches_single():
    """The pipeline's whole-map VI GBA (`mapping_ctl.global_ba_chunked`) with
    a 2-shard CPU mesh set by `enable_mesh` against the unsharded call on the
    bootstrapped map with its landmarks spread over the table
    (`chip_smoke.spread_landmarks`: both shards hold landmarks) and moved off
    its optimum (`chip_smoke.perturbed_map`: 2 cm seeded offsets), as the
    oracle test_pipeline_gba_mesh_matches_single does with a fresh map; 4
    chunks of 512 landmarks, 2 a shard. Float32
    reduction order only: keyframe positions to 1e-4 m, landmarks to 1e-3 m
    (the JAX test holds 5e-3 / 2e-2), and the unsharded BA must move the
    keyframes by more than 10 x that tolerance, so that a shard's missing
    share could not pass."""
    import chip_smoke
    _, cam, ext, res, _ = boot_run()
    slam = res["slam"]
    st = copy.deepcopy(slam.st)
    window = list(st.kf_slots)
    m0 = chip_smoke.perturbed_map(chip_smoke.spread_landmarks(slam.m), window)
    assert m0.mp_active.reshape(2, -1).sum(1).min() > 100
    args = (m0, st, slam.cfg, cam, ext, slam.gw, slam.noise, window)
    m_ref, ba_ref = mapping_ctl.global_ba_chunked(*args, prune=False, chunk=512)
    sys2 = copy.copy(slam)
    sys2.st = st
    sys2.enable_mesh(dist_ba.make_mesh(devices=["cpu", "cpu"]),
                     dist_ba.make_mesh(axis="e", devices=["cpu", "cpu"]))
    assert slam.st.mesh is None and sys2.mesh.size == 2
    m_d, ba_d = mapping_ctl.global_ba_chunked(*args, prune=False, chunk=512)
    act = slam.m.kf_active.numpy()
    mpa = m0.mp_active.numpy()
    assert np.abs(m_ref.kf_ns.P.numpy()[act] - m0.kf_ns.P.numpy()[act]).max() > 10 * 1e-4
    np.testing.assert_allclose(m_d.kf_ns.P.numpy()[act], m_ref.kf_ns.P.numpy()[act], atol=1e-4)
    np.testing.assert_allclose(m_d.mp_pos.numpy()[mpa], m_ref.mp_pos.numpy()[mpa], atol=1e-3)
    np.testing.assert_allclose(float(ba_d.cost), float(ba_ref.cost), rtol=1e-4)


def test_close_loop_mesh_matches_single():
    """`close_loop(mesh=)` (the edge-sharded essential graph) against the
    unsharded call on the bootstrapped map with a planted loop correction
    between the newest and the oldest keyframe: poses to 1e-4 m."""
    from mc_slam_tpu_torch.geometry.sim3solver import Sim3Result
    _, cam, _, res, _ = boot_run()
    slam = res["slam"]
    slots = list(slam.st.kf_slots)
    sim3 = Sim3Result(ok=True, s=torch.tensor(1.02), R=torch.eye(3),
                      t=torch.tensor([0.01, -0.02, 0.005]), inliers=None, n_inliers=100)
    kw = dict(fix_scale=True, kf_ids=slam.st.kf_id_host)
    m_ref = loopclosing.close_loop(slam.m, slots, slots[-1], slots[0], sim3, cam, **kw)
    m_d = loopclosing.close_loop(slam.m, slots, slots[-1], slots[0], sim3, cam,
                                 mesh=dist_ba.make_mesh(axis="e", devices=["cpu"] * 3), **kw)
    act = slam.m.kf_active.numpy()
    np.testing.assert_allclose(m_d.kf_ns.P.numpy()[act], m_ref.kf_ns.P.numpy()[act], atol=1e-4)
    np.testing.assert_allclose(m_d.mp_pos.numpy(), m_ref.mp_pos.numpy(), atol=1e-4)
