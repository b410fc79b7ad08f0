"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
small track-and-map profile and the bootstrap profile with their cached runs,
conversion of the port's MapState to the JAX package's, field-by-field
comparison of two maps, and the replay of the JAX package's RANSAC samples."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from mc_slam_tpu.camera import make_camera as j_make_camera
from mc_slam_tpu.imu.navstate import NavState as JNavState
from mc_slam_tpu.imu.preintegration import PreintState as JPreint
from mc_slam_tpu.slam_map import mapstate as jms
from mc_slam_tpu.solver import factors as jfac
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.slam_map.mapstate import MapState

# small enough for XLA:CPU to compile the event programs in seconds:
# K = 8 keyframes, P = 1024 points, F = 256 features, window <= 4 (+ padding)
SMALL = chip_smoke.Profile(width=320, height=240, n_feat=256, n_levels=3, max_mp=1024,
                           max_kf=8, n_frames=21, kf_every=10, tex_size=256,
                           local_window=4, max_new=64, ba_Pw=512)

# EuRoC's camera-from-body extrinsic as numpy (Rcb, tcb)
_RCB = chip_smoke.TBC[:3, :3].T.astype(np.float32)
TBC_EXT = (_RCB, (-_RCB @ chip_smoke.TBC[:3, 3]).astype(np.float32))

# the bootstrap fixture: wide enough for a 5 s VI initialization that the
# float32 init solve conditions well (at 320x240 / 256 features the step-3
# system is rank-poor and the two packages' results drift apart), small
# enough for XLA:CPU: K = 16 keyframes, P = 2048 points, F = 512 features
BOOT = chip_smoke.Profile(width=480, height=360, n_feat=512, n_levels=4, max_mp=2048,
                          max_kf=16, n_frames=106, kf_every=10, tex_size=512,
                          local_window=4, max_new=128, ba_Pw=1024, vi_init_time=5.0,
                          init_max_frame=10, boot_max_frame=101, n_vi_frames=4)

INT_FIELDS = ("kf_mp", "mp_active", "mp_ref_kf", "mp_first_kf", "kf_active", "kf_id",
              "kf_level", "kf_feat_valid", "kf_desc", "kf_pm1", "mp_desc", "mp_pm1")


def jax_samples(key, w, n_iters=200):
    """The (n_iters, 8) sample indices that the JAX package's
    init2view.initialize_two_view(key, ..., w, ...) draws inside
    (its lines :231-234, repeated with the same key)."""
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    return np.asarray(jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-12))[None, :].repeat(n_iters * 8, 0)
    ).reshape(n_iters, 8))


def jax_map(m: MapState):
    """The port's MapState as the JAX package's (numpy leaves)."""
    d = dict(convert.to_numpy(m))
    d["kf_ns"] = JNavState(**d["kf_ns"])
    d["kf_preint"] = JPreint(**d["kf_preint"])
    return jms.MapState(**d)


def torch_map(jm):
    """A JAX MapState as the port's, on the CPU."""
    return convert.to_torch(MapState, jax.tree_util.tree_map(np.asarray, jm), "cpu")


def jax_cam(cam):
    return j_make_camera(*[float(getattr(cam, f)) for f in
                           ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")],
                         width=cam.width, height=cam.height)


def jax_ext():
    return jfac.extrinsics_from_Tbc(chip_smoke.TBC)


def assert_maps_match(jm, tm, rtol=1e-5, atol=1e-5, skip=(), msg=""):
    """Integer / bool / descriptor tables exactly, float tables to tolerance."""
    got = convert.to_numpy(tm)
    ref = jax.tree_util.tree_map(np.asarray, jm)._asdict()
    for k, rv in ref.items():
        if k in skip:
            continue
        if isinstance(rv, tuple):
            for kk, vv in rv._asdict().items():
                np.testing.assert_allclose(got[k][kk], vv, rtol=rtol, atol=atol,
                                           err_msg=f"{msg} {k}.{kk}")
        elif k in INT_FIELDS:
            np.testing.assert_array_equal(got[k], rv, err_msg=f"{msg} {k}")
        else:
            np.testing.assert_allclose(got[k], rv, rtol=rtol, atol=atol,
                                       err_msg=f"{msg} {k}")


@functools.lru_cache(maxsize=None)
def small_run():
    """The small profile's track-and-map run on the CPU (2 keyframe events).
    Returns (seq, cam, ext, result, captured) where captured[i] is the
    (MapState, MappingState, frame index) right after the i-th keyframe's
    insertion, before its event."""
    torch.set_num_threads(2)
    seq = chip_smoke.make_sequence(SMALL, seed=0)
    cam = chip_smoke.profile_camera(SMALL, "cpu")
    ext = chip_smoke.factors.extrinsics_from_Tbc(chip_smoke.TBC, device="cpu")
    captured = []
    rec = chip_smoke.SearchRecorder(keep_frames={0, 19}, timed=False)
    res = chip_smoke.run_track_and_map(
        seq, SMALL, cam, ext, "cpu", recorder=rec,
        on_event=lambda m, st, i: captured.append((m, copy.deepcopy(st), i)))
    res["recorder"] = rec
    return seq, cam, ext, res, captured


@functools.lru_cache(maxsize=None)
def boot_run():
    """chip_smoke.py's path 3 at the BOOT profile on the CPU: two-view
    initialization from raw frames, visual tracking and mapping, VI
    initialization at 5 s, four VI frames (~50 s). Returns (seq, cam, ext,
    result, captured), `captured` as chip_smoke.capture_bootstrap_states
    yields it."""
    torch.set_num_threads(2)
    seq = chip_smoke.make_sequence(BOOT, seed=0)
    cam = chip_smoke.profile_camera(BOOT, "cpu")
    ext = chip_smoke.factors.extrinsics_from_Tbc(chip_smoke.TBC, device="cpu")
    with chip_smoke.capture_bootstrap_states() as captured:
        res = chip_smoke.run_bootstrap(seq, BOOT, cam, ext, "cpu")
    return seq, cam, ext, res, captured
