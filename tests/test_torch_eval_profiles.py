"""The port's evaluation envelope against the JAX script's
(examples/eval_clone.py): the profile tables and the five SlamConfigs, the
drift injection (against a numpy transcription of `_inject`, to 1e-6, on the
map of `small_run()`), its start and cutoff across a save and a resume, the
acceptance gate's decisions, and the phase "evict" of chip_smoke.py at a
small size on the CPU."""
import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.pipeline.system import SlamConfig
from mc_slam_tpu_torch.tools import eval_clone
from torch_port_helpers import BOOT, small_run

ROOT = Path(__file__).resolve().parent.parent
JAX_SCRIPT = ROOT / "examples" / "eval_clone.py"


@pytest.fixture(scope="module")
def jax_script():
    """examples/eval_clone.py as a module (its top level is numpy only)."""
    spec = importlib.util.spec_from_file_location("jax_eval_clone", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_profile_configs():
    """profile -> the keyword arguments of the SlamConfig that the JAX
    script's if / elif / else chain builds (:136-155), read from its source."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    chain = next(n for n in ast.walk(main) if isinstance(n, ast.If)
                 and "args.profile" in ast.unparse(n.test)
                 and "SlamConfig" in ast.unparse(n.body[0]))

    def kwargs(body):
        call = next(n for n in ast.walk(body[0]) if isinstance(n, ast.Call))
        return {k.arg: ast.literal_eval(k.value) for k in call.keywords}

    out, node = {}, chain
    while True:
        cmp = node.test
        names = ast.literal_eval(cmp.comparators[0])
        for name in (names if isinstance(names, tuple) else (names,)):
            out[name] = kwargs(node.body)
        if len(node.orelse) == 1 and isinstance(node.orelse[0], ast.If):
            node = node.orelse[0]
            continue
        out["small"] = kwargs(node.orelse)     # the else branch: the last choice
        return out


def test_profile_tables_equal_jax(jax_script):
    assert eval_clone.PROFILE_GEN == jax_script.PROFILE_GEN
    assert eval_clone.PROFILE_DURATION == jax_script.PROFILE_DURATION
    # the same folders, kept in the checkout instead of /tmp
    assert set(eval_clone.PROFILE_DATASET) == set(jax_script.PROFILE_DATASET)
    for k, v in jax_script.PROFILE_DATASET.items():
        assert Path(eval_clone.PROFILE_DATASET[k]).name == Path(v).name
    np.testing.assert_array_equal(eval_clone.TBC.astype(np.float32), jax_script.TBC)


@pytest.mark.parametrize("profile", ["euroc", "mid", "small", "loops", "hard"])
def test_profile_config_equals_jax(profile):
    jax_kw = jax_profile_configs()
    assert set(jax_kw) == set(eval_clone.PROFILES)
    cfg = eval_clone.profile_config(profile)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(SlamConfig(**jax_kw[profile]))


def test_euroc_profile_is_the_parents_run():
    """No flag builds the config and the data of the tool before the
    profiles: the 2400-frame run's checkpoints stay loadable."""
    assert eval_clone.profile_config("euroc") == SlamConfig(
        max_kf=512, max_mp=16384, n_feat=1024, n_levels=8, local_window=20, use_imu=True,
        vi_init_time=15.0, g_mag=9.810)
    a = eval_clone.parse_args([])
    assert (a.profile, a.dataset, a.out) == (
        "euroc", "_scratch/euroc_clone", "artifacts/ate_clone_euroc_torch.json")
    assert (a.duration, a.fps, a.seed, a.tex_size, a.tex_scale, a.harden, a.blur_ms, a.laps,
            a.imu_noise_scale, a.yaw_scale, a.tex_contrast, a.weak_walls, a.weak_contrast) == (
        120.0, 20.0, 0, 2048, 1.0, True, 12.0, 1, 1.0, 1.0, 1.0, [], 0.3)
    assert (a.bg, a.ba) == ([0.003, -0.0045, 0.0035], [0.035, -0.02, 0.06])
    assert not a.inject_drift and not a.gate


def test_profile_arguments_apply_and_yield_to_the_command_line():
    h = eval_clone.parse_args(["--profile", "hard"])
    assert (h.laps, h.yaw_scale, h.blur_ms, h.tex_contrast, h.duration) == (2, 1.6, 25.0, 0.55,
                                                                           60.0)
    assert (h.dataset, h.out) == ("_scratch/euroc_clone_hard",
                                  "artifacts/ate_clone_hard_torch.json")
    lp = eval_clone.parse_args(["--profile", "loops", "--blur-ms", "20", "--duration", "100"])
    assert (lp.laps, lp.imu_noise_scale, lp.weak_walls, lp.weak_contrast) == (2, 6.0, [1, 3],
                                                                              0.45)
    assert (lp.blur_ms, lp.duration) == (20.0, 100.0)
    s = eval_clone.parse_args(["--profile", "small", "--out", "x/ate_clone_s.json"])
    assert (s.dataset, s.laps, s.duration) == ("_scratch/euroc_clone", 1, 120.0)
    assert eval_clone.side_path(s.out, "traj", "small").endswith("x/traj_clone_s.npz")
    assert eval_clone.side_path("x/r.json", "map", "small").endswith("x/map_clone_small_torch.png")


@pytest.mark.parametrize("steps", [["0.0008", "-0.0005", "0.0005", "0.0004"],
                                   ["8e-4", "-5e-4", "5e-4", "4e-4"],
                                   ["8E-4", "-5E-04", "0.5e-3", "4.0e-4"]],
                         ids=["decimal", "exponent", "mixed"])
def test_drift_step_parses_written_either_way(steps):
    """The README's loop-demo steps, in decimals and with exponents: argparse
    alone reads "-5e-4" as an option; the port's parser takes all three."""
    a = eval_clone.parse_args(["--profile", "euroc", "--inject-drift", "--drift-window", "20",
                               "50", "--drift-step", *steps, "--no-loops"])
    assert a.drift_step == [0.0008, -0.0005, 0.0005, 0.0004]
    assert a.drift_window == [20.0, 50.0] and a.inject_drift and a.no_loops
    assert eval_clone.parse_args(["--bg", "-1e-3", "-2", "-.5"]).bg == [-0.001, -2.0, -0.5]


def _np_inject(m, ns_last, ns0, Rg, tg, cutoff):
    """examples/eval_clone.py's `_inject` (:174-196) in numpy, on dicts."""
    kf_sel = m["kf_active"] & (m["kf_id"] > cutoff)
    ns = m["kf_ns"]
    P2 = np.where(kf_sel[:, None], ns["P"] @ Rg.T + tg, ns["P"])
    R2 = np.where(kf_sel[:, None, None], np.einsum("ij,kjl->kil", Rg, ns["R"]), ns["R"])
    V2 = np.where(kf_sel[:, None], ns["V"] @ Rg.T, ns["V"])
    mp_sel = m["mp_active"] & (m["mp_first_kf"] > cutoff)
    X2 = np.where(mp_sel[:, None], m["mp_pos"] @ Rg.T + tg, m["mp_pos"])
    N2 = np.where(mp_sel[:, None], m["mp_normal"] @ Rg.T, m["mp_normal"])
    move = lambda s: dict(P=Rg @ s["P"] + tg, R=Rg @ s["R"], V=Rg @ s["V"])
    return dict(P=P2, R=R2, V=V2, X=X2, N=N2), move(ns_last), move(ns0)


def _ns(m, slot):
    return NavState(*[getattr(m.kf_ns, f)[slot].clone() for f in NavState._fields])


@pytest.mark.parametrize("cutoff", [9, 15])
def test_inject_drift_matches_numpy_transcription(cutoff):
    from mc_slam_tpu_torch import convert
    m = small_run()[3]["m"]           # after both events: points of frames 10 and 20
    ns_last, ns0 = _ns(m, 1), _ns(m, 0)
    before = convert.to_numpy(m)
    snap = [t.clone() for t in (m.kf_ns.P, m.kf_ns.R, m.kf_ns.V, m.mp_pos, m.mp_normal,
                                ns_last.P, ns0.R)]
    Rg, tg = eval_clone.drift_step([8e-4, -5e-4, 5e-4, 4e-4], "cpu")
    m2, ns2, ns02 = eval_clone.inject_drift(m, ns_last, ns0, Rg, tg, cutoff)
    ref, ref_last, ref_0 = _np_inject(before, convert.to_numpy(ns_last), convert.to_numpy(ns0),
                                      Rg.numpy(), tg.numpy(), cutoff)
    got = dict(P=m2.kf_ns.P, R=m2.kf_ns.R, V=m2.kf_ns.V, X=m2.mp_pos, N=m2.mp_normal)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)
    for got_s, ref_s in ((ns2, ref_last), (ns02, ref_0)):
        for k in ("P", "R", "V"):
            np.testing.assert_allclose(getattr(got_s, k).numpy(), ref_s[k], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_s.bg.numpy(), ns_last.bg.numpy() if got_s is ns2
                                      else ns0.bg.numpy())
    # something moved and something did not, and the inputs are as they were
    moved = (before["kf_id"] > cutoff) & before["kf_active"]
    assert moved.any() and (~moved & before["kf_active"]).any()
    assert ((before["mp_first_kf"] > cutoff) & before["mp_active"]).any()
    for a, b in zip(snap, (m.kf_ns.P, m.kf_ns.R, m.kf_ns.V, m.mp_pos, m.mp_normal, ns_last.P,
                           ns0.R)):
        assert torch.equal(a, b)
    assert eval_clone.inject_drift(m, ns_last, None, Rg, tg, cutoff)[2] is None


def test_jax_drift_injector_is_the_scripts_text():
    """torch_port_helpers.jax_drift_injector, the JAX side of the injection
    parity test under the frame loop (tests/test_torch_frameloop.py): its
    `_inject` and `maybe_inject` are the script's, node for node, and its
    step rotation is the script's `so3_exp` of [0, 0, yaw] to 2e-7."""
    import jax.numpy as jnp
    from mc_slam_tpu import lie as jlie
    from torch_port_helpers import jax_drift_rotation

    def fn(body, name):
        return next(n for n in body if isinstance(n, ast.FunctionDef) and n.name == name)
    main = fn(ast.parse(JAX_SCRIPT.read_text()).body, "main")
    helper = fn(ast.parse((ROOT / "tests" / "torch_port_helpers.py").read_text()).body,
                "jax_drift_injector")
    for name in ("_inject", "maybe_inject"):
        assert ast.dump(fn(helper.body, name)) == ast.dump(fn(main.body, name)), name
    for yaw in (4e-4, -1.5e-4):
        ref = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.0, np.float32(yaw)])), np.float32)
        np.testing.assert_allclose(np.asarray(jax_drift_rotation(yaw)), ref, rtol=0, atol=2e-7)


@pytest.mark.parametrize("loop", [False, True], ids=["synchronous", "frame_loop"])
def test_drift_state_survives_a_save_and_resume(tmp_path, monkeypatch, loop):
    """--inject-drift across two calls: the first injected frame's time and
    the cutoff go into PATH.run.json and the resumed call carries on from
    them, in the synchronous mode and in the frame loop at LAG_MAX 12 /
    PAIR 2 (the save flushes the loop; the injector runs after every call
    there too). The injector is stood in for by one that starts on the first
    frame (this short run reaches no VI init) and moves nothing."""
    torch.set_num_threads(2)
    if loop:
        monkeypatch.setenv("MC_SLAM_LAG_MAX", "12")
        monkeypatch.setenv("MC_SLAM_PAIR", "2")
    else:
        monkeypatch.delenv("MC_SLAM_LAG_MAX", raising=False)
        monkeypatch.delenv("MC_SLAM_PAIR", raising=False)
    seen = []

    def start(self, slam, t):
        seen.append((self.t_start, self.cutoff))
        if self.t_start is None:
            self.t_start = t
        if self.cutoff is None:
            self.cutoff = slam.frame_id - 1
        self.n_injected += 1
        return True

    monkeypatch.setattr(eval_clone.DriftInjector, "__call__", start)
    ck = str(tmp_path / "ck.npz")
    # the unhardened clone initializes at frame 10; the first call saves there
    common = ["--profile", "small", "--device", "cpu", "--duration", "1.5", "--no-harden",
              "--tex-size", "1024", "--inject-drift", "--drift-window", "0", "100"]
    r1 = eval_clone.main(common + ["--max-frames", "1", "--save-checkpoint", ck,
                                   "--out", str(tmp_path / "ate_clone_a.json")])
    run = json.loads(Path(ck + ".run.json").read_text())
    d = run["drift"]
    assert d["t_start"] is not None and d["cutoff"] is not None and d["n_injected"] > 0
    assert r1["drift_params"]["cutoff_fid"] == d["cutoff"]
    n_first = len(seen)
    r2 = eval_clone.main(common + ["--resume", ck, "--max-frames", "15",
                                   "--out", str(tmp_path / "ate_clone_b.json")])
    assert seen[n_first] == (d["t_start"], d["cutoff"])      # the resumed injector's state
    p = r2["drift_params"]
    assert (p["t_start"], p["cutoff_fid"]) == (d["t_start"], d["cutoff"])
    assert r1["frames"] == d["n_injected"] == 11 and d["cutoff"] == 0
    assert r2["frames"] == 15 and p["frames_injected"] == 15
    assert r2["drift_injected"] and r2["profile"] == "small" and len(r2["calls"]) == 2
    assert (r1["lag_max"], r1["pair"], r2["lag_max"], r2["pair"]) == ((12, 2) * 2 if loop
                                                                      else (1, 1) * 2)
    # the resumed call's first frame went out through the loop and was harvested
    assert ("harvest_pull" in r2["stage_detail"]) == loop
    assert r2["evictions"] == dict(keyframes=0, keyframes_after_vi=0, point_passes=0, points=0)
    assert (tmp_path / "map_clone_b.png").exists()
    z = np.load(tmp_path / "traj_clone_b.npz")
    assert len(z["anchor_kid"]) == len(z["t_est"]) == r2["tracked_rows"]


def _result(**kw):
    r = dict(profile="euroc", max_lost_streak=0, tracking_finished_ok=True,
             ate_rmse_post_init=0.01, abs_scale_err=0.001, n_lost=0, loops_closed=0,
             loop_closing_enabled=True, e2e_fps_amortized=25.0)
    r.update(kw)
    return r


GATE_CASES = [
    (_result(), True, []),
    (_result(ate_rmse_post_init=0.2), True, ["ate_rmse_post_init"]),
    (_result(abs_scale_err=0.03), False, ["abs_scale_err"]),
    (_result(n_lost=61), False, ["n_lost"]),
    (_result(n_lost=60, ate_rmse_post_init=0.15, abs_scale_err=0.02), False, []),
    (_result(e2e_fps_amortized=0.75), True, ["e2e_fps"]),
    (_result(e2e_fps_amortized=0.75), False, []),             # the frame rate: on the card only
    # hard: survival only (accuracy and lost frames are not its gate)
    (_result(profile="hard", n_lost=540, ate_rmse_post_init=0.5, max_lost_streak=100), False, []),
    (_result(profile="hard", max_lost_streak=271), False, ["max_lost_streak"]),
    (_result(profile="hard", tracking_finished_ok=False), False, ["did not finish"]),
    (_result(profile="loops"), False, ["loops_closed"]),
    (_result(profile="loops", loops_closed=1), False, []),
    (_result(profile="loops", loop_closing_enabled=False), False, []),
    (_result(profile="mid", ate_rmse_post_init=0.2, n_lost=70, e2e_fps_amortized=1.0), True,
     ["ate_rmse_post_init", "n_lost", "e2e_fps"]),
]


@pytest.mark.parametrize("result,on_card,fails", GATE_CASES)
def test_gate_decisions(result, on_card, fails):
    got = eval_clone.gate(result, on_card)
    assert len(got) == len(fails) and all(f in g for f, g in zip(fails, got)), got


# ---- the phase "evict" of chip_smoke.py at a small size ----------------------------

# the BOOT profile with tables cut to fill within its 106 frames: 9 keyframes
# (VI init needs 8) and 340 points (the orphan sweep above 90 % holds a
# table of 560 under the 95 % at which eviction starts)
EVICT_SMALL = dataclasses.replace(BOOT, max_kf=9, max_mp=340)


@pytest.fixture(scope="module")
def evict_run():
    torch.set_num_threads(2)
    seq = chip_smoke.make_sequence(EVICT_SMALL, seed=0)
    cam = chip_smoke.profile_camera(EVICT_SMALL, "cpu")
    res, watch = chip_smoke.run_evict(seq, EVICT_SMALL, cam, "cpu")
    return seq, res, watch


def test_evict_phase_counts_and_checks(evict_run):
    """The phase's run on the CPU: the allocator evicts at capacity, an
    event's maintenance evicts points (counted from the tables before and
    after), the table never overflows, and `check_evict` passes with the
    card's thresholds (2 keyframe evictions, 1 after VI init, 1 pass)."""
    seq, res, watch = evict_run
    slam = res["slam"]
    assert watch["kf"] and all(e["n_active"] <= EVICT_SMALL.max_kf for e in watch["kf"])
    assert all(e["K"] == EVICT_SMALL.max_kf and e["slot"] in range(EVICT_SMALL.max_kf)
               for e in watch["kf"])
    passes = [e for e in watch["mp"] if e["evicted"] > 0]
    assert passes and all(e["after"] == e["before"] - e["evicted"] for e in passes)
    # eviction runs above 95 % occupancy and takes at most 7 % of the table
    assert all(e["before"] > 0.95 * e["P"] and e["evicted"] <= int(0.07 * e["P"])
               for e in passes)
    assert all(e["evicted"] == 0 for e in watch["mp"] if e["before"] <= 0.95 * e["P"])
    got = chip_smoke.check_evict(res, watch, seq, EVICT_SMALL)
    assert got["kf_evicted"] == len(watch["kf"]) and got["mp_passes"] == len(passes)
    assert got["most_active_kf"] <= EVICT_SMALL.max_kf == slam.m.K
    assert len(slam.kf_slots) == int(slam.m.kf_active.sum())


@pytest.mark.parametrize("change,message", [
    (dict(kf=[]), "keyframes evicted"),
    (dict(kf_vi=False), "after VI"),
    (dict(mp=[]), "point-eviction"),
    (dict(over=True), "over capacity"),
])
def test_evict_checks_fail(evict_run, change, message):
    """check_evict refuses a record without evictions, without one after VI
    init, without a point-eviction pass, or over capacity."""
    seq, res, watch = evict_run
    w = dict(kf=[dict(e) for e in watch["kf"]], mp=[dict(e) for e in watch["mp"]])
    if "kf" in change:
        w["kf"] = []
    if change.get("kf_vi") is False:
        for e in w["kf"]:
            e["vi"] = False
    if "mp" in change:
        w["mp"] = []
    if change.get("over"):
        w["kf"][0]["n_active"] = EVICT_SMALL.max_kf + 1
    with pytest.raises(AssertionError, match=message):
        chip_smoke.check_evict(res, w, seq, EVICT_SMALL, min_kf=1, min_kf_vi=1)
