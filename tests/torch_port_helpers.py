"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
small track-and-map profile and the bootstrap profile with their cached runs,
conversion of the port's MapState to the JAX package's, field-by-field
comparison of two maps, and the replay of the JAX package's RANSAC samples."""
import contextlib
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


def jax_samples(key, w, n_iters=200, k=8):
    """The (n_iters, k) sample indices that the JAX package's RANSAC
    functions draw inside from `key` and the weights `w`:
    init2view.initialize_two_view (200 x 8, its lines :231-234),
    pnp.pnp_ransac (256 x 6, :86-89), sim3solver.sim3_ransac (300 x 3,
    :87-90), repeated here with the same key."""
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    return np.asarray(jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-12))[None, :].repeat(n_iters * k, 0)
    ).reshape(n_iters, k))


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


def jax_system_from_port(monkeypatch, cam, tm, st, traj=None, frame_id=0, profile=None,
                         **cfg_kw):
    """A JAX SlamSystem in parity mode (one frame a dispatch, pipeline depth
    1, every summary consumed at once) that holds the port's state: the
    MapState `tm` converted, and the host bookkeeping of `st` / `traj` as
    `convert.host_state_to_dict` hands it over."""
    from mc_slam_tpu.pipeline.pipebase import OK
    from mc_slam_tpu.pipeline.system import SlamConfig, SlamSystem
    p = profile or BOOT
    monkeypatch.setenv("MC_SLAM_PAIR", "1")
    monkeypatch.setenv("MC_SLAM_LAG_MAX", "1")
    kw = dict(max_kf=tm.K, max_mp=tm.P, n_feat=tm.F, n_levels=p.n_levels,
              local_window=p.local_window, use_imu=True, vi_init_time=p.vi_init_time)
    kw.update(cfg_kw)
    js = SlamSystem(jax_cam(cam), SlamConfig(**kw), Tbc=chip_smoke.TBC)
    js._summary_ready = lambda pend: True
    js.frame_id = frame_id
    js.state = OK
    js.m = jax.tree_util.tree_map(jnp.asarray, jax_map(tm))
    d = convert.host_state_to_dict(st, traj)
    for name in convert.HOST_FIELDS.values():
        setattr(js, name, d[name])
    js.kf_imu_raw = d["kf_imu_raw"]
    if d["covis_row"] is not None:
        js._covis_row_cache = (st.last_kf_slot, d["covis_row"])
    if d.get("traj_rows") is not None:
        for i, meta in enumerate(d["traj_meta"]):
            js.traj.append(tuple(jnp.asarray(a[i]) for a in d["traj_rows"]), *meta)
    return js


def assert_host_state_matches(js, st):
    """The host tables of a JAX SlamSystem against the port's MappingState."""
    d = convert.host_state_to_dict(st)
    for name in convert.HOST_FIELDS.values():
        if name == "_ref_tracked_cache":
            continue            # a cache: the JAX class drops it at other moments
        assert getattr(js, name) == d[name], name
    assert set(js.kf_imu_raw) == set(d["kf_imu_raw"])
    for k, rows in d["kf_imu_raw"].items():
        np.testing.assert_array_equal(np.asarray(js.kf_imu_raw[k]), rows, err_msg=f"rows of {k}")


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
    """chip_smoke.py's path 3 at the BOOT profile on the CPU, through
    SlamSystem.track: two-view
    initialization from raw frames, visual tracking and mapping, VI
    initialization at 5 s, four VI frames (~50 s). Returns (seq, cam, ext,
    result, captured), `captured` as chip_smoke.capture_bootstrap_states
    yields it."""
    torch.set_num_threads(2)
    seq = chip_smoke.make_sequence(BOOT, seed=0)
    cam = chip_smoke.profile_camera(BOOT, "cpu")
    ext = chip_smoke.factors.extrinsics_from_Tbc(chip_smoke.TBC, device="cpu")
    with chip_smoke.capture_bootstrap_states() as captured:
        res = chip_smoke.run_bootstrap(seq, BOOT, cam, "cpu")
    return seq, cam, ext, res, captured


REVISIT_SRC = 30        # the replayed stretch of the BOOT sequence starts at this frame
REVISIT_FRAMES = 46     # ... and has so many frames


@functools.lru_cache(maxsize=None)
def revisit_run():
    """chip_smoke.py's path 5 at the BOOT profile on the CPU, on a COPY of
    `boot_run()`'s system: three blank frames lose the camera, the carried
    pose and gyro bias are corrupted, frames REVISIT_SRC .. +REVISIT_FRAMES-1
    are fed again: relocalization, the 20-frame bias window, VI tracking with
    keyframes (~30 s on top of boot_run). Returns (seq, cam, ext, slam, rv,
    cap): the copied system after the replay, `chip_smoke.run_revisit`'s dict,
    and what was captured on the way: cap["lost"] the (MapState, MappingState,
    TrackState) right after the corruption, cap["window"] the (MapState,
    TrackState) handed to `recompute_bias_from_window`."""
    from mc_slam_tpu_torch.pipeline import tracking_ctl
    seq, cam, ext, res, _ = boot_run()
    torch.set_num_threads(2)
    slam = copy.deepcopy(res["slam"])
    cap = {}
    orig = (tracking_ctl.recompute_bias_from_window, tracking_ctl.relocalize)

    def spy_window(m, ts, *a, **k):
        cap["window"] = (m, copy.copy(ts))
        return orig[0](m, ts, *a, **k)

    def spy_reloc(m, st, cfg, ts, *a, **k):
        if float(ts.P[0]) == 5.0 and "lost" not in cap:      # the corrupted pose
            cap["lost"] = (m, copy.deepcopy(st), copy.copy(ts))
        return orig[1](m, st, cfg, ts, *a, **k)

    tracking_ctl.recompute_bias_from_window, tracking_ctl.relocalize = spy_window, spy_reloc
    try:
        rv = chip_smoke.run_revisit(dict(res, slam=slam), seq, BOOT, REVISIT_SRC,
                                    REVISIT_FRAMES)
    finally:
        tracking_ctl.recompute_bias_from_window, tracking_ctl.relocalize = orig
    return seq, cam, ext, slam, rv, cap


@contextlib.contextmanager
def jax_features():
    """While active, the port's ORB extraction hands out the JAX package's
    feature table of the same image (`mc_slam_tpu.frontend.extractor.extract`,
    converted): a run of the port then sees exactly the features a run of
    the JAX package sees (its own differ from them in a few descriptor bits,
    from the pyramid's 1e-4)."""
    from mc_slam_tpu.frontend import extractor as jex
    from mc_slam_tpu_torch.frontend import extractor as tex
    orig = tex.extract

    def extract(img, n_features=1024, n_levels=8, **kw):
        jf = jex.extract(jnp.asarray(img.cpu().numpy(), jnp.float32), n_features=n_features,
                         n_levels=n_levels, **kw)
        return convert.to_torch(tex.Features, jax.tree_util.tree_map(np.asarray, jf)._asdict(),
                                img.device)

    tex.extract = extract
    try:
        yield
    finally:
        tex.extract = orig


@contextlib.contextmanager
def jax_init_samples(seed=0):
    """While active, the port's two-view attempts draw the 200 x 8 samples
    that a JAX SlamSystem seeded `seed` draws in its attempts of the same
    order (one split of its key per attempt that reaches the RANSAC)."""
    from mc_slam_tpu_torch.geometry import init2view as tinit
    orig = tinit.draw_samples
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(w, n_iters=200, generator=None):
        state["key"], sub = jax.random.split(state["key"])
        return torch.as_tensor(jax_samples(sub, jnp.asarray(w.cpu().numpy()), n_iters, 8),
                               dtype=torch.int64, device=w.device)

    tinit.draw_samples = draw
    try:
        yield
    finally:
        tinit.draw_samples = orig
