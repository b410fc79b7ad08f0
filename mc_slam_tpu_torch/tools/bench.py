"""The JAX repo's benchmark (bench.py) for the port: the same workloads,
sizes and seeds, written with the port's functions.

    python3 -m mc_slam_tpu_torch.tools.bench [--device cuda|cpu]
        [--e2e-frames N] [--small]

Prints ONE JSON line with bench.py's structure, {"metric", "value", "unit",
"vs_baseline", "sub": {...}}, where vs_baseline is frames/s over the
reference's 20 frames/s; progress goes to stderr as "# ..." lines.

1. frame tracking: a 752x480 image of uniform noise (default_rng(0)),
   `extractor.extract` (1024 features, 8 levels) and
   `tracking.track_frame_visual` (10 LM iterations) against a 16384-point
   map, the map an argument of the timed function; the projection searches
   run the CUDA kernel `hamming_top2_windowed`. The mean of 20 calls after
   2 warm-ups (`frame_tracking_fps`), with the launches a frame: every
   kernel and copy under torch.profiler, and the kernel's own counter.
2. extraction alone (`extraction_ms`).
3. the local-window VI BA (`bench_problems.vi_window_problem(20, 2048, 512)`,
   `ba_vi.vi_ba`, 10 iterations: `vi_ba_20kf_ms`) and its inverse-depth form
   (`vi_window_idp_problem`, `ba_vi_idp.vi_ba_idp`: `vi_ba_idp_20kf_ms`).
4. 8 sequences in one batched step (`multiseq.make_batched_step` on the map
   stacked 8 times: `batched8_fps_aggregate`; one kernel launch a search).
5. the plain Hamming matrix 1024 x 16384 and its sum (`hamming_gpairs_s`),
   and the CUDA kernel on the frame step's first search, 16384 map points x
   1024 features at r = 15 px (`kernel_gpairs_s`, pairs gated a second; warm,
   timed with `probes.time_cuda`).
6. speed of light: the operations and bytes of the Hamming sum, the IDP BA
   and the extraction from their shapes (`workload_counts`), over the
   measured times, against the H100's published peaks (67 TFLOP/s float32
   outside the tensor cores, TF32 being off in the port; 3.35 TB/s) scaled
   by the card's power limit over 700 W. A share over 100 % is an error.
7. end to end: `tools.eval_clone --profile euroc --max-frames N` in a
   subprocess (N from --e2e-frames, else BENCH_E2E_FRAMES, else 600: the
   bootstrap, VI init at frame 300 and 300 VI frames; the JAX default of
   2400 is `--e2e-frames 2400`); 0 turns it off. When it is off or fails the
   headline is frame_tracking_fps and the clone's accuracy comes from the
   newest artifact, labelled CACHED.
8. robustness: the loops profile, the hard profile and the vocabulary
   evaluation from the port's artifacts, labelled "cached artifact" (the
   JAX bench runs the loops profile live when its clone is on disk; on the
   card its 4800 frames take longer than one call, so the row says how many
   frames its artifact covers).
9. scaling: `tools.bench_scaling` in a subprocess, under sub["scaling"].

sub["device"] is the card's name and power limit (`probes.card_line()`),
or "cpu". `--small` shrinks every workload (160x120, 256 features, 3 levels,
512 map points, BA windows of 4 keyframes and 128 points) for tests on the
host; on the CPU no device metric is reported (times are the host's, the
launch counts and roofline shares are null).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mc_slam_tpu_torch.tools import probes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DC = 15                     # a keyframe's NavState dimensions (P, V, R, bg, ba)

FULL = dict(H=480, W=752, n_feat=1024, n_levels=8, n_mp=16384, ba_kf=20, ba_pts=2048,
            ba_obs_per_kf=512, batch=8)
SMALL = dict(H=120, W=160, n_feat=256, n_levels=3, n_mp=512, ba_kf=4, ba_pts=128,
             ba_obs_per_kf=64, batch=2)
BA_ITERS = 10
E2E_FRAMES = 600


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def synthetic_inputs(sz, seed=0):
    """bench.py's inputs as numpy, in its draw order: the noise image, the
    map's positions and its descriptor words (uint32)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (sz["H"], sz["W"])).astype(np.float32)
    P = sz["n_mp"]
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
                    rng.uniform(3, 12, P)], 1).astype(np.float32)
    words = rng.integers(0, 2 ** 32, size=(P, 8), dtype=np.uint32)
    return img, pts, words


def synthetic_map(sz, pts, words, device):
    """bench.py's map: empty_map(4, P, F) with every point active at the
    given positions and descriptors (packed words and their +/-1 rows, as
    the map always holds both), min distance 0.5 m, max 30 m."""
    from mc_slam_tpu_torch.frontend.orb import unpack_pm1
    from mc_slam_tpu_torch.slam_map.mapstate import empty_map
    P = pts.shape[0]
    m = empty_map(max_kf=4, max_mp=P, n_feat=sz["n_feat"], device=device)
    desc = torch.from_numpy(words.view(np.int32).copy()).to(device)
    return m._replace(mp_pos=torch.from_numpy(pts).to(device), mp_desc=desc,
                      mp_pm1=unpack_pm1(desc),
                      mp_active=torch.ones(P, dtype=torch.bool, device=device),
                      mp_min_dist=torch.full((P,), 0.5, device=device),
                      mp_max_dist=torch.full((P,), 30.0, device=device))


def make_frame_step(cam, ext, sz):
    """bench.py's fused frame step: extract, then track_frame_visual with a
    10-iteration LM against the map given as an argument."""
    from mc_slam_tpu_torch.frontend import extractor
    from mc_slam_tpu_torch.pipeline import tracking

    def frame_step(img, m, P0, R0):
        f = extractor.extract(img, n_features=sz["n_feat"], n_levels=sz["n_levels"])
        res = tracking.track_frame_visual(m, f, f.xy, cam, ext, P0, R0, iters=10)
        return res.P, res.n_inliers
    return frame_step


def ba_problems(sz, device):
    """The XYZ and the inverse-depth window problems of workload 3."""
    from mc_slam_tpu_torch.bench_problems import vi_window_idp_problem, vi_window_problem
    kw = dict(n_kf=sz["ba_kf"], n_pts=sz["ba_pts"], obs_per_kf=sz["ba_obs_per_kf"],
              device=device)
    return vi_window_problem(**kw), vi_window_idp_problem(**kw)


def ba_calls(p, pi, iters=BA_ITERS):
    """(vi_ba call, vi_ba_idp call); each returns its cost curve."""
    from mc_slam_tpu_torch.solver import ba_vi, ba_vi_idp

    def vi():
        return ba_vi.vi_ba(p["ns"], p["pts"], p["obs"], p["edges"], p["cam"], p["ext"],
                           p["gw"], p["free"], p["pt_mask"], iters=iters)[4]

    def idp():
        return ba_vi_idp.vi_ba_idp(pi["ns"], pi["rho"], pi["idp_obs"], pi["edges"],
                                   pi["cam"], pi["ext"], pi["gw"], pi["free"],
                                   pi["rho_mask"], iters=iters)[4]
    return vi, idp


def numbered(rec, tag, f):
    """f, with the recorder's frame set to (tag, n) on its n-th call, so a
    recorder keeping (tag, 0) keeps the searches of the first call."""
    calls = itertools.count()

    def g():
        rec.frame = (tag, next(calls))
        return f()
    return g


def workload_counts(sz, n_obs_idp, iters=BA_ITERS):
    """Operations and bytes of three workloads, from their shapes alone:

    * hamming: the (A, 256) x (P, 256) +/-1 product, 2 A P 256 operations; its
      int8 inputs read once and the sum written once;
    * idp_ba: `iters` LM iterations, each a linearization (an observation:
      2 residual rows over 13 unknowns, anchor pose, observer pose and the
      inverse depth: the 3 x 13 chain rule, J^T J and J^T r, and 60 for the
      residual itself; an IMU edge: 15 rows over two 15-d states), a Schur
      reduction (a point seen by c = min(K, 1 + O / N) keyframes adds its 6c
      x 6c outer product) and a solve (the Cholesky of the 15 K system, two
      triangular solves, the landmarks' back-substitution); the bytes of the
      problem read once (48 a row of observations, 108 a state, 1168 an IMU
      edge, 4 an inverse depth) and its outputs written once;
    * extraction: bytes only, bench.py's pyramid-pass estimate."""
    A, P = sz["n_feat"], sz["n_mp"]
    K, N, O = sz["ba_kf"], sz["ba_pts"], n_obs_idp
    ham_ops = 2 * A * P * 256
    ham_bytes = (A + P) * 256 + 4
    R, U = 2, 13
    lin_obs = 2 * R * 3 * U + 2 * R * U * U + 2 * R * U + 60
    Re, Ue = 15, 2 * DC
    lin_edge = 2 * Re * Ue * Ue + 2 * Re * Ue
    c = min(K, 1 + O / N)
    schur = N * 2 * (6 * c) ** 2
    d = DC * K
    solve = d ** 3 / 3 + 2 * 2 * d * d + N * 2 * 6 * c
    idp_ops = iters * (O * lin_obs + (K - 1) * lin_edge + schur + solve)
    idp_bytes = O * 48 + K * 108 + (K - 1) * 1168 + N * 4 + K * 108 + N * 4 + O * 4
    ex_bytes = sz["H"] * sz["W"] * (1 + 1 / 1.44 + 1 / 2.07) * 4 * 20
    return {"hamming": {"operations": float(ham_ops), "bytes": float(ham_bytes)},
            "idp_ba": {"operations": float(idp_ops), "bytes": float(idp_bytes)},
            "extraction": {"operations": None, "bytes": float(ex_bytes)}}


def speed_of_light(counts, dt_hm, dt_idp, dt_ex, power_w):
    """Achieved rates and roofline shares against the published peaks
    (`probes`), scaled by power_w / 700 W; raises when a share reads over
    100 %."""
    scale = min(1.0, power_w / probes.PEAK_POWER_W)
    f32, hbm = probes.FLOAT_OPS_PER_S * scale, probes.HBM_BYTES_PER_S * scale
    hm_rate = counts["hamming"]["operations"] / dt_hm
    idp_rate = counts["idp_ba"]["operations"] / dt_idp
    ex_bw = counts["extraction"]["bytes"] / dt_ex
    sol = {"hamming_tflops": hm_rate / 1e12, "hamming_pct_f32_peak": 100 * hm_rate / f32,
           "idp_ba_tflops": idp_rate / 1e12, "idp_ba_pct_f32_peak": 100 * idp_rate / f32,
           "extraction_gbs": ex_bw / 1e9, "extraction_pct_hbm_peak": 100 * ex_bw / hbm,
           "peaks": {"f32_tflops": f32 / 1e12, "hbm_tbs": hbm / 1e12, "power_limit_w": power_w}}
    over = {k: v for k, v in sol.items() if k.endswith("_peak") and v > 100.0}
    if over:
        raise SystemExit(f"bench: roofline share over 100 % {over}: a count or a time is wrong")
    return sol


def timeit(f, cuda, n=20, warmup=2):
    """bench.py's timeit: the host-clock mean of n calls after `warmup`,
    ending in torch.cuda.synchronize where JAX blocks until ready. Returns
    (seconds, the last call's result)."""
    for _ in range(warmup):
        f()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = f()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, out


def device_ops(fn):
    """(kernels, copies and sets) the card ran for one fn(), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()       # not the shadows of StageTimer stages
          if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in ev)
    return len(ev) - copies, copies


def run_workloads(sz, device, n_frame=20, n_ex=20, n_ba=5, n_batched=10, n_hm=20,
                  profile=True):
    """Workloads 1-6 in this process; with `profile` (on the card) the
    kernels and copies of a frame step and of a batched step under
    torch.profiler, last. A `probes.search_recorder` in front of the kernel's
    wrapper keeps the searches of the first frame step and of the first
    batched step. Returns (sub dict, detail dict with the BA cost curves,
    the kernel's launches by workload and the recorder)."""
    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.frontend import extractor, match_cuda, matching
    from mc_slam_tpu_torch.parallel import multiseq
    from mc_slam_tpu_torch.solver import factors
    cuda = device.type == "cuda"
    counter = match_cuda.LIB           # the kernel's launches, whatever shim is in front of it
    img_np, pts, words = synthetic_inputs(sz)
    cam = euroc_camera(device=device)
    ext = factors.identity_extrinsics(device=device)
    img = torch.from_numpy(img_np).to(device)
    m = synthetic_map(sz, pts, words, device)
    P0, R0 = torch.zeros(3, device=device), torch.eye(3, device=device)
    rec = probes.search_recorder(keep_frames={("frame_step", 0), ("batched_step", 0)})
    detail = {"launches": {}, "recorder": rec}

    # 1: the fused frame step
    frame_step = make_frame_step(cam, ext, sz)
    counter.launches = 0
    with rec:
        dt_frame, _ = timeit(numbered(rec, "frame_step", lambda: frame_step(img, m, P0, R0)),
                             cuda, n=n_frame)
    detail["launches"]["frame_step"] = counter.launches
    fps = 1.0 / dt_frame
    log(f"frame_tracking: {dt_frame * 1e3:.2f} ms -> {fps:.1f} fps "
        f"(kernel launches {counter.launches} in {n_frame + 2} calls)")

    # 2: extraction alone
    ex = lambda: extractor.extract(img, n_features=sz["n_feat"], n_levels=sz["n_levels"]).xy
    dt_ex, _ = timeit(ex, cuda, n=n_ex)
    log(f"extraction: {dt_ex * 1e3:.2f} ms")

    # 3: the window VI BA, XYZ and inverse depth
    p, pi = ba_problems(sz, device)
    vi, idp = ba_calls(p, pi)
    dt_ba, vi_costs = timeit(vi, cuda, n=n_ba)
    log(f"local VI BA ({BA_ITERS} LM iters): {dt_ba * 1e3:.2f} ms "
        f"-> {BA_ITERS / dt_ba:.1f} LM iters/s")
    dt_idp, idp_costs = timeit(idp, cuda, n=n_ba)
    log(f"IDP window BA ({BA_ITERS} LM iters): {dt_idp * 1e3:.2f} ms")
    detail["vi_ba_costs"] = vi_costs.cpu().numpy().tolist()
    detail["vi_ba_idp_costs"] = idp_costs.cpu().numpy().tolist()

    # 4: B sequences in one batched step
    B = sz["batch"]
    ms = multiseq.stack_maps([m] * B)
    imgs_b = img[None].expand(B, -1, -1).contiguous()
    P0b, R0b = torch.zeros(B, 3, device=device), torch.eye(3, device=device).expand(B, 3, 3)
    mstep = multiseq.make_batched_step(cam, ext, n_features=sz["n_feat"],
                                       n_levels=sz["n_levels"])
    counter.launches = 0
    with rec:
        dt_ms, _ = timeit(numbered(rec, "batched_step", lambda: mstep(ms, imgs_b, P0b, R0b)[0]),
                          cuda, n=n_batched)
    detail["launches"]["batched_step"] = counter.launches
    fps_agg = B / dt_ms
    log(f"batched {B}-seq tracking: {dt_ms * 1e3:.2f} ms -> {fps_agg:.0f} frames/s "
        f"aggregate (kernel launches {counter.launches} in {n_batched + 2} calls)")

    # 5: the plain Hamming matrix, and the CUDA kernel on the first search
    pm1 = m.mp_pm1
    a = pm1[:sz["n_feat"]]
    hm = lambda: matching.hamming_matrix(a, pm1).sum()
    dt_hm, _ = timeit(hm, cuda, n=n_hm)
    rate = a.shape[0] * pm1.shape[0] / dt_hm / 1e9
    log(f"hamming {a.shape[0]}x{pm1.shape[0]}: {dt_hm * 1e3:.3f} ms -> {rate:.1f} Gpairs/s")
    kernel_rate = None
    if cuda:
        _, args, kw = rec.calls[0]              # the first frame step's first search
        dt_k = probes.time_cuda(lambda: match_cuda._WRAPPER(*args, **kw)) / 1e3
        M, N = args[0].shape[0], args[5].shape[0]
        kernel_rate = M * N / dt_k / 1e9
        log(f"hamming_top2_windowed {M}x{N} r={args[10]:g}: {dt_k * 1e6:.2f} us -> "
            f"{kernel_rate:.1f} Gpairs/s gated")

    # 6: speed of light
    counts = workload_counts(sz, int((pi["idp_obs"].valid > 0).sum()))
    sol = launches = batched_launches = None
    if cuda:
        sol = speed_of_light(counts, dt_hm, dt_idp, dt_ex, probes.power_limit_w(probes.card_line()))
        log(f"speed-of-light: {sol}")
    if cuda and profile:
        # the profiler last: it slows what runs after it
        k, c = device_ops(lambda: frame_step(img, m, P0, R0))
        launches = {"kernels": k, "copies": c,
                    "hamming_top2_windowed": detail["launches"]["frame_step"] / (n_frame + 2)}
        log(f"launches a frame: {k} kernels, {c} copies and sets")
        k, c = device_ops(lambda: mstep(ms, imgs_b, P0b, R0b))
        batched_launches = {"kernels": k, "copies": c, "hamming_top2_windowed":
                            detail["launches"]["batched_step"] / (n_batched + 2)}
    sub = {
        "extraction_ms": dt_ex * 1e3,
        "vi_ba_20kf_ms": dt_ba * 1e3,
        "vi_ba_idp_20kf_ms": dt_idp * 1e3,
        "hamming_gpairs_s": rate,
        "kernel_gpairs_s": kernel_rate,
        "batched8_fps_aggregate": fps_agg,
        "speed_of_light": sol,
        "counts": counts,
        "frame_tracking_ms": dt_frame * 1e3,
        "frame_tracking_fps": fps,
        "launches_per_frame": launches,
        "launches_per_batched_step": batched_launches,
    }
    return sub, detail


# the keys of the end-to-end run's JSON that bench.py reports, by its names
E2E_KEYS = {"e2e_fps_amortized": "e2e_fps_amortized", "e2e_fps_warm": "e2e_fps_warm",
            "e2e_median_track_ms": "median_track_ms", "e2e_stage_ms": "stages",
            "e2e_frames": "frames", "e2e_n_lost": "n_lost",
            "ate_clone_rmse_m": "ate_rmse", "ate_clone_rmse_post_init_m": "ate_rmse_post_init",
            "ate_clone_frames": "frames", "ate_clone_profile": "profile",
            "ate_clone_loops": "loops_closed", "ate_clone_dataset": "dataset",
            "ate_clone_dataset_hash": "dataset_hash", "ate_clone_commit": "commit"}


def clone_keys(e2e):
    out = {k: e2e.get(src) for k, src in E2E_KEYS.items()}
    scale = e2e.get("ate_scale")
    out["ate_clone_abs_scale_err"] = None if scale is None else abs(1.0 - scale)
    return out


def run_module(args, timeout):
    """`python3 -m <args>` from the checkout's root; raises with the end of
    its stderr when it fails."""
    try:
        return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=timeout, check=True)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"{' '.join(args)}: rc {err.returncode}: "
                           f"{(err.stderr or '')[-600:]}") from err


def end_to_end(frames, device, sub):
    """Workload 7; returns the amortized frames/s, or None when it failed."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ate_clone_bench.json")
        try:
            run_module(["mc_slam_tpu_torch.tools.eval_clone", "--profile", "euroc",
                        "--max-frames", str(frames), "--device", device.type, "--out", out],
                       timeout=3000)
            with open(out) as f:
                e2e = json.load(f)
        except (RuntimeError, subprocess.SubprocessError, OSError, ValueError) as err:
            log(f"e2e bench skipped: {err}")
            return None
    sub.update(clone_keys(e2e))
    log(f"e2e on {device.type} ({e2e['frames']} frames): {e2e['e2e_fps_amortized']} fps "
        f"amortized ({e2e.get('e2e_fps_warm')} warm), ate {e2e.get('ate_rmse')}")
    return e2e["e2e_fps_amortized"]


def robustness(sub):
    """Workload 8, from the port's artifacts, each labelled "cached
    artifact": the loops profile (its 4800 frames take two calls on the card,
    joined through a checkpoint; `frames` against `profile_frames` says how
    far the artifact's run got), the hard profile and the vocabulary
    evaluation."""
    from mc_slam_tpu_torch.tools.eval_clone import PROFILE_DURATION
    art = os.path.join(ROOT, "artifacts")
    path = os.path.join(art, "ate_clone_loops_torch.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        sub["loops_profile"] = {k: d.get(k) for k in (
            "frames", "e2e_fps_amortized", "loops_closed", "n_lost", "max_lost_streak",
            "ate_rmse", "ate_rmse_post_init", "card")}
        sub["loops_profile"]["profile_frames"] = int(PROFILE_DURATION["loops"] * 20)   # 20 Hz
        sub["loops_profile"]["provenance"] = "cached artifact"
    path = os.path.join(art, "ate_clone_hard_torch.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        sub["hard_profile"] = {k: d.get(k) for k in ("n_lost", "n_relocs", "max_lost_streak",
                                                      "tracking_finished_ok", "card")}
        sub["hard_profile"]["provenance"] = "cached artifact"
    path = os.path.join(art, "vocab_eval_torch.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        sub["vocab_eval"] = {w: v["recall_at_1"] for w, v in d.get("worlds", {}).items()}
        sub["vocab_eval"]["provenance"] = "cached artifact"


def cached_clone(sub):
    """The clone's accuracy from the newest artifact, labelled CACHED, when
    no live end-to-end run gave it."""
    for name in ("ate_clone_euroc_torch.json", "ate_clone_mid_torch.json"):
        path = os.path.join(ROOT, "artifacts", name)
        if os.path.exists(path):
            with open(path) as f:
                sub.update({k: v for k, v in clone_keys(json.load(f)).items()
                            if k.startswith("ate_clone_")})
            sub["ate_clone_provenance"] = (f"CACHED artifact {name} - live e2e run "
                                           "unavailable")
            log(f"clone ATE (CACHED artifact, live run unavailable): {path}")
            return


def scaling(device, small, sub):
    """Workload 9: tools.bench_scaling's JSON under sub["scaling"]."""
    try:
        r = run_module(["mc_slam_tpu_torch.tools.bench_scaling", "--device", device.type]
                       + (["--small"] if small else []), timeout=1800)
        sub["scaling"] = json.loads(r.stdout.strip().splitlines()[-1])
        log(f"scaling: {sub['scaling']}")
    except (RuntimeError, subprocess.SubprocessError, OSError, ValueError, IndexError) as err:
        log(f"scaling bench skipped: {err}")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--e2e-frames", type=int, default=None,
                    help=f"frames of the end-to-end run (default BENCH_E2E_FRAMES or "
                         f"{E2E_FRAMES}; 0: off)")
    ap.add_argument("--small", action="store_true", help="small workloads, for the host")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no GPU (pass --device cpu to run on the host)")
        card = probes.card_line()
    else:
        card = "cpu"
    log(f"device: {card}")
    sz = SMALL if args.small else FULL
    sub, _ = run_workloads(sz, device)
    sub["device"] = card
    sub["sizes"] = sz
    frames = args.e2e_frames
    if frames is None:
        frames = int(os.environ.get("BENCH_E2E_FRAMES", E2E_FRAMES))
    e2e_fps = end_to_end(frames, device, sub) if frames else None
    robustness(sub)
    scaling(device, args.small, sub)
    if e2e_fps is None:
        cached_clone(sub)
    fps = sub["frame_tracking_fps"]
    if e2e_fps is not None:
        head = {"metric": "e2e_pipeline_fps", "value": e2e_fps,
                "unit": f"frames/s amortized, full pipeline on {card} (euroc clone)",
                "vs_baseline": e2e_fps / 20.0}
    else:
        head = {"metric": "frame_tracking_fps", "value": fps,
                "unit": f"frames/s on {card} ({sz['W']}x{sz['H']}, {sz['n_feat']} feat, "
                        f"{sz['n_mp']}-pt map)",
                "vs_baseline": fps / 20.0}
    print(json.dumps({**head, "sub": sub}), flush=True)


if __name__ == "__main__":
    main()
