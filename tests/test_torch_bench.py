"""The port's benchmark tools against the JAX repo's (bench.py,
examples/bench_scaling.py) on the CPU, at `--small` widths.

* The synthetic inputs (noise image, map positions, descriptor words and
  their +/-1 rows, distance band) equal bench.py's construction from the
  same seed, at the full and the small sizes.
* The fused frame step (extract + track_frame_visual, 10 LM iterations)
  against the JAX package's on the same image and map, both on the JAX
  feature table (`torch_port_helpers.jax_features`): the two extractors
  differ in a few descriptor bits, which a noise image against a random map
  turns into other matches. Under the shared table the pose agrees to 1e-4 m
  and the inlier count exactly; the port's own extraction is held to the
  front-end tests' tolerances (tests/test_torch_frontend.py).
* The analytic operation and byte counts against hand counts at two sizes.
* Part A's problem and `ba_chunked.vi_gba_chunked` (8 keyframes, 512
  points, 8 chunks, 2 iterations) against the JAX package's: the problem
  and its chunking equal; the synthetic window starts far from its optimum
  (random IMU rows), so the two solves are held relative to the moves of
  the port's (keyframes 5e-3, landmarks 2e-3 of them) and the final cost to
  1e-4 relative.
* `tools.bench.main` on the CPU prints one JSON line with bench.py's keys;
  `run_workloads` records the searches of its first frame step and first
  batched step.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.bench_problems import vi_window_problem as j_vi_window_problem
from mc_slam_tpu.camera import euroc_camera as j_euroc_camera
from mc_slam_tpu.frontend import extractor as jex
from mc_slam_tpu.frontend.orb import unpack_pm1 as j_unpack_pm1
from mc_slam_tpu.pipeline import tracking as jtracking
from mc_slam_tpu.slam_map.mapstate import empty_map as j_empty_map
from mc_slam_tpu.solver import ba_chunked as jbc, factors as jfac
from mc_slam_tpu_torch.camera import euroc_camera
from mc_slam_tpu_torch.frontend import extractor as tex
from mc_slam_tpu_torch.solver import ba_chunked as tbc, factors as tfac
from mc_slam_tpu_torch.frontend import match_cuda
from mc_slam_tpu_torch.tools import bench, bench_scaling, probes

from torch_port_helpers import jax_features, small_run

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
_np = lambda x: jax.tree_util.tree_map(np.asarray, x)


def jax_bench_inputs(sz):
    """bench.py:58-78 at the sizes `sz`: the image, the map and P0 / R0."""
    rng = np.random.default_rng(0)
    H, W, P = sz["H"], sz["W"], sz["n_mp"]
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    m = j_empty_map(max_kf=4, max_mp=P, n_feat=sz["n_feat"])
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
                    rng.uniform(3, 12, P)], 1).astype(np.float32)
    words = rng.integers(0, 2 ** 32, size=(P, 8), dtype=np.uint32)
    pm1 = j_unpack_pm1(jnp.asarray(words))
    m = m._replace(mp_pos=jnp.asarray(pts), mp_pm1=pm1, mp_active=jnp.ones(P, bool),
                   mp_min_dist=jnp.full(P, 0.5), mp_max_dist=jnp.full(P, 30.0))
    return img, m, words


@pytest.mark.parametrize("name", ["full", "small"])
def test_synthetic_inputs_match_jax_bench(name):
    sz = bench.FULL if name == "full" else bench.SMALL
    jimg, jm, jwords = jax_bench_inputs(sz)
    img, pts, words = bench.synthetic_inputs(sz)
    m = bench.synthetic_map(sz, pts, words, CPU)
    np.testing.assert_array_equal(img, np.asarray(jimg))
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(m.mp_desc.numpy().view(np.uint32), jwords)
    for f in ("mp_pos", "mp_pm1", "mp_active", "mp_min_dist", "mp_max_dist"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(jm, f)), f)
    assert m.mp_pos.shape == (sz["n_mp"], 3) and m.F == sz["n_feat"]


@pytest.fixture(scope="module")
def small_frame():
    sz = bench.SMALL
    jimg, jm, _ = jax_bench_inputs(sz)
    img, pts, words = bench.synthetic_inputs(sz)
    return sz, jimg, jm, torch.from_numpy(img), bench.synthetic_map(sz, pts, words, CPU)


def test_frame_step_matches_jax_on_shared_features(small_frame):
    sz, jimg, jm, img, m = small_frame
    jf = jex.extract(jimg, n_features=sz["n_feat"], n_levels=sz["n_levels"])
    jr = jtracking.track_frame_visual(jm, jf, jf.xy, j_euroc_camera(),
                                      jfac.identity_extrinsics(), jnp.zeros(3), jnp.eye(3),
                                      iters=10)
    step = bench.make_frame_step(euroc_camera(device=CPU), tfac.identity_extrinsics(device=CPU),
                                 sz)
    with jax_features():
        P, n_in = step(img, m, torch.zeros(3), torch.eye(3))
    np.testing.assert_allclose(P.numpy(), np.asarray(jr.P), rtol=0, atol=1e-4)
    assert int(n_in) == int(jr.n_inliers)
    # the kernel's arguments of the first search: the whole map against the frame, 15 px
    with probes.search_recorder(keep_frames=1) as rec:
        step(img, m, torch.zeros(3), torch.eye(3))
    assert len(rec.calls) == 2
    _, args, kw = rec.calls[0]
    assert args[0].shape == (sz["n_mp"], 8) and args[5].shape == (sz["n_feat"], 8)
    assert args[10] == 15.0 and not kw


def test_frame_step_extraction_matches_jax(small_frame):
    """The port's own extraction of the bench image, within the front-end
    tests' tolerances."""
    sz, jimg, _, img, _ = small_frame
    fj = _np(jex.extract(jimg, n_features=sz["n_feat"], n_levels=sz["n_levels"]))
    ft = tex.extract(img, n_features=sz["n_feat"], n_levels=sz["n_levels"])
    np.testing.assert_array_equal(ft.level.numpy(), fj.level)
    np.testing.assert_array_equal(ft.valid.numpy(), fj.valid)
    n_bits_differ = int((ft.desc_pm1.numpy() != fj.desc_pm1).sum())
    assert n_bits_differ <= 0.0005 * fj.desc_pm1.size, n_bits_differ
    np.testing.assert_allclose(ft.xy.numpy(), fj.xy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ft.angle.numpy(), fj.angle, rtol=0, atol=1e-4)
    assert fj.valid.sum() >= 32        # 41 of the 256 rows on this 160x120 image


# hand counts: per LM iteration an observation costs 2*2*3*13 (chain rule)
# + 2*2*13*13 (J^T J) + 2*2*13 (J^T r) + 60 = 944 operations, an IMU edge
# 2*15*30*30 + 2*15*30 = 27900
@pytest.mark.parametrize("sz,n_obs,ham_ops,ham_bytes,idp_ops,idp_bytes,ex_bytes", [
    (bench.FULL, 10000, 8_589_934_592, 4_456_452,
     # c = 1 + 10000/2048; 10 x (10000*944 + 19*27900 + 2048*2*(6c)^2 + 300^3/3 + 4*300^2
     #                          + 2048*12c)
     10 * (10000 * 944 + 19 * 27900 + 2048 * 2 * (6 * (1 + 10000 / 2048)) ** 2
           + 9_000_000 + 360_000 + 2048 * 12 * (1 + 10000 / 2048)),
     10000 * 52 + 20 * 216 + 19 * 1168 + 2048 * 8, 752 * 480 * 80 * (1 + 1 / 1.44 + 1 / 2.07)),
    (bench.SMALL, 200, 67_108_864, 196_612,
     # c = min(4, 1 + 200/128) = 2.5625; the Cholesky of 60 x 60
     10 * (200 * 944 + 3 * 27900 + 128 * 2 * 15.375 ** 2 + 72_000 + 14_400 + 128 * 12 * 2.5625),
     200 * 52 + 4 * 216 + 3 * 1168 + 128 * 8, 160 * 120 * 80 * (1 + 1 / 1.44 + 1 / 2.07)),
])
def test_workload_counts_match_hand_counts(sz, n_obs, ham_ops, ham_bytes, idp_ops, idp_bytes,
                                           ex_bytes):
    c = bench.workload_counts(sz, n_obs)
    assert c["hamming"] == {"operations": ham_ops, "bytes": ham_bytes}
    np.testing.assert_allclose(c["idp_ba"]["operations"], idp_ops, rtol=1e-12)
    assert c["idp_ba"]["bytes"] == idp_bytes
    np.testing.assert_allclose(c["extraction"]["bytes"], ex_bytes, rtol=1e-12)
    assert c["extraction"]["operations"] is None


def test_speed_of_light_refuses_a_share_over_100_percent():
    c = bench.workload_counts(bench.FULL, 10000)
    sol = bench.speed_of_light(c, 1.0, 1.0, 1.0, 700.0)
    assert sol["peaks"] == {"f32_tflops": 67.0, "hbm_tbs": 3.35, "power_limit_w": 700.0}
    half = bench.speed_of_light(c, 1.0, 1.0, 1.0, 350.0)
    np.testing.assert_allclose(half["hamming_pct_f32_peak"], 2 * sol["hamming_pct_f32_peak"])
    with pytest.raises(SystemExit, match="over 100 %"):
        bench.speed_of_light(c, 1e-5, 1.0, 1.0, 700.0)
    assert probes.power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0


def test_part_a_matches_jax_chunked_gba():
    """examples/bench_scaling.py:106-113 at 8 keyframes, 512 points and 8
    chunks through both packages, 2 iterations."""
    s = bench_scaling.SMALL
    (ns, pts, cobs, edges, cam, ext, gw, free, ptm), meta = bench_scaling.synthetic_problem(
        **s, device=CPU)
    p = j_vi_window_problem(n_kf=s["n_kf"], n_pts=s["n_pts"], obs_per_kf=s["obs_per_kf"])
    o = _np(p["obs"])
    jcobs, _ = jbc.chunk_observations(o.cam, o.pt, o.uv, o.inv_sigma2, o.valid, s["n_pts"],
                                      s["chunks"])
    for f in ("cam", "pt", "uv", "inv_sigma2", "valid"):
        np.testing.assert_array_equal(getattr(cobs, f).numpy(), np.asarray(getattr(jcobs, f)))
    np.testing.assert_allclose(ns.P.numpy(), np.asarray(p["ns"].P), atol=1e-6)
    np.testing.assert_allclose(pts.numpy(), np.asarray(p["pts"]), atol=0)
    assert meta == {"source": "synthetic", "n_kf": 8, "n_pts": 512,
                    "n_obs": int(o.valid.sum()), "chunks": 8}
    nsj, pj, cost_j = jbc.vi_gba_chunked(p["ns"], p["pts"], jcobs, p["edges"], p["cam"],
                                         p["ext"], p["gw"], p["free"], p["pt_mask"], iters=2)
    a = bench_scaling.part_a((ns, pts, cobs, edges, cam, ext, gw, free, ptm), meta, 2, CPU)
    nst, pt, cost_t, costs = tbc.vi_gba_chunked(ns, pts, cobs, edges, cam, ext, gw, free, ptm,
                                                iters=2)
    # the window's IMU rows are random, so the first steps move keyframes by
    # ~2 m and landmarks by ~70 m from a cost of 1.4e7: the float32 sums in
    # another order part the two solves by ~3e-3 (keyframes) and ~1e-3
    # (landmarks) of those moves (measured), the cost by ~2e-5
    move_P = float((nst.P - ns.P).abs().max())
    move_X = float((pt - pts).abs().max())
    assert move_P > 1.0 and move_X > 10.0
    np.testing.assert_allclose(nst.P.numpy(), np.asarray(nsj.P), rtol=0, atol=5e-3 * move_P)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=2e-3 * move_X)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-4)
    np.testing.assert_allclose(a["costs"], costs.numpy(), rtol=1e-6)
    assert a["costs"][-1] <= a["costs"][0] and a["measured_iter_ms_1dev"] > 0
    assert a["launches_per_iter"] is None and a["peak_device_MiB"] is None
    d = 8 * bench_scaling.DV
    assert bench_scaling.comm_bytes(8, 512) == {"psum_reduced_system": (d * d + 2 * d + 1) * 4,
                                                "gather_landmark_steps": 512 * 12}


def test_part_a_checkpoint_problem_matches_jax(tmp_path, monkeypatch):
    """--ckpt: the map of a checkpoint (small_run()'s, written with
    io.checkpoint) becomes the same problem as examples/bench_scaling.py's
    build_problem (:61-104) makes of it: chunks, states, IMU edges, masks
    and meta (the PRV information, a float32 inverse, within
    test_torch_solver.py's tolerance)."""
    from mc_slam_tpu_torch.io import checkpoint
    m = small_run()[3]["m"]
    slots = [int(s) for s in np.nonzero(m.kf_active.numpy())[0]]
    path = str(tmp_path / "ck.npz")
    checkpoint.save_map(path, m, {"kf_slots": slots, "gw": [0.0, 0.0, -9.81]})
    monkeypatch.setenv("MC_SLAM_SCALE_CKPT", path)
    spec = importlib.util.spec_from_file_location("jax_bench_scaling",
                                                  ROOT / "examples" / "bench_scaling.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    *jprob, jmeta = script.build_problem()
    tprob, meta = bench_scaling.checkpoint_problem(path, CPU)
    assert meta == jmeta and meta["n_kf"] == len(slots) >= 3
    jns, jpts, jcobs, jedges, _, _, jgw, jfree, jptm = jprob
    ns, pts, cobs, edges, _, _, gw, free, ptm = tprob
    for f in ("cam", "pt", "uv", "inv_sigma2", "valid"):
        np.testing.assert_array_equal(getattr(cobs, f).numpy(), np.asarray(getattr(jcobs, f)))
    for a, b in [(ns, jns), (edges.pre, jedges.pre)]:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in ((pts, jpts), (edges.info_bias, jedges.info_bias), (gw, jgw), (free, jfree),
                 (ptm, jptm)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=0)
    ij = np.asarray(jedges.info_prv)        # a float32 inverse: test_torch_solver.py's tolerance
    np.testing.assert_allclose(edges.info_prv.numpy(), ij, rtol=1e-3, atol=1e-3 * np.abs(ij).max())


# bench.py's sub keys that do not depend on the device, with e2e off
JAX_KEYS = ("extraction_ms", "vi_ba_20kf_ms", "vi_ba_idp_20kf_ms", "hamming_gpairs_s",
            "batched8_fps_aggregate", "speed_of_light", "frame_tracking_fps", "hard_profile",
            "vocab_eval", "scaling", "ate_clone_rmse_m", "ate_clone_rmse_post_init_m",
            "ate_clone_frames", "ate_clone_profile", "ate_clone_loops",
            "ate_clone_abs_scale_err", "ate_clone_provenance")


def test_bench_main_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")      # the scaling subprocesses
    bench.main(["--device", "cpu", "--small", "--e2e-frames", "0"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    r = json.loads(out[0])
    assert r["metric"] == "frame_tracking_fps" and r["value"] > 0
    np.testing.assert_allclose(r["vs_baseline"], r["value"] / 20.0)
    sub = r["sub"]
    missing = [k for k in JAX_KEYS if k not in sub]
    assert not missing, missing
    assert sub["device"] == "cpu" and sub["sizes"] == bench.SMALL
    # no device metric from a host run
    assert sub["speed_of_light"] is None and sub["kernel_gpairs_s"] is None
    assert sub["launches_per_frame"] is None
    assert sub["ate_clone_provenance"].startswith("CACHED")
    assert sub["hard_profile"]["provenance"] == "cached artifact"
    loops = sub["loops_profile"]
    assert loops["provenance"] == "cached artifact" and loops["profile_frames"] == 4800
    assert 0 < loops["frames"] <= 4800
    assert sub["scaling"]["problem"]["n_kf"] == 8
    assert "not a scaling measurement" in sub["scaling"]["cpu_mesh_structural"]["note"]
    assert match_cuda.hamming_top2_windowed is match_cuda._WRAPPER     # the recorder is gone


def test_run_workloads_records_the_first_steps_searches():
    """The recorder run_workloads puts in front of the kernel's wrapper
    keeps the two searches of the first frame step and of the first batched
    step (chip_smoke.py's phase "bench" holds the kernel against its twin on
    them) and nothing of the other calls."""
    sz = bench.SMALL
    _, det = bench.run_workloads(sz, CPU, n_frame=1, n_ex=1, n_ba=1, n_batched=1, n_hm=1)
    calls = det["recorder"].calls
    assert [c[0] for c in calls] == [("frame_step", 0)] * 2 + [("batched_step", 0)] * 2
    single, batched = calls[0][1], calls[2][1]
    assert single[0].shape == (sz["n_mp"], 8) and single[10] == 15.0
    assert batched[0].shape == (sz["batch"], sz["n_mp"], 8) and batched[10] == 15.0
    assert match_cuda.hamming_top2_windowed is match_cuda._WRAPPER
