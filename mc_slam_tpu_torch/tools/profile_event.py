"""Stage tables of the keyframe events and of the bootstrap at the euroc
profile's full width.

    python3 -m mc_slam_tpu_torch.tools.profile_event [--path vi|bootstrap|revisit|depth]
        [--events 3] [--out profile_event.json]

`--path vi` (the default) runs chip_smoke.py's track-and-map path up to the
insertion of keyframe `--events`, then runs that Mono+IMU event stage by
stage (the calls of mapping.kf_event_pre, mapping_ctl.local_ba_idp and
mapping.kf_event_post, in their order). `--path bootstrap` runs
chip_smoke.py's bootstrap path from raw frames to the accepted VI
initialization, keeping the states it hands to its stages, then runs alone:
the two-view initialization, one visual frame, the last visual keyframe
event stage by stage (its BA is the visual window BA), and the VI
initialization stage by stage (whole-map visual BA, the init solve, the
batched re-preintegration, whole-map VI BA, and `maybe_vi_init` whole).
`--path revisit` runs chip_smoke.py's paths 4 and 5 (the system to VI
tracking, three blank frames, the earlier frames again, the planted seam and
its closure), keeping the states handed to the relocalization attempts and to
the bias window, then runs alone: a failed relocalization attempt, the
successful one whole and stage by stage (BoW histogram and scores, the batched
candidate evaluation, the refinement against the map), the 20-frame bias
solve, and the stages of the loop event (detection, the Sim3 batch, the guided
verification, the pose graph, both fusion rounds, the whole-map BA).
`--path depth` runs chip_smoke.py's path 7 (rectified stereo + IMU to 20 VI
frames after VI init), keeping the states handed to the VI trackers and to
the keyframe events, then runs alone: one stereo VI frame (both
extractions, `stereo_depth`, the whole depth lookup, the VI tracker with the
u_right rows) and one keyframe event after VI init stage by stage, its BA the
XYZ window VI BA with the u_right rows.
Each stage runs under torch.profiler and with
torch.cuda.set_sync_debug_mode("warn"): host milliseconds (host clock, the
stage ends in a synchronize), device-busy milliseconds (sum of the kernels'
device time), kernels launched, and the device->host synchronizations with
the source lines that caused them. Needs a GPU; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def measure(name, fn, rows):
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn()
                t_enqueue = time.perf_counter() - t0
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_at = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    dev_us, kernels = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += ev.device_time
            kernels += 1
    rows.append(dict(stage=name, host_ms=host_ms, enqueue_ms=t_enqueue * 1e3,
                     device_ms=dev_us / 1e3, device_busy_share=dev_us / 1e3 / host_ms,
                     kernels=kernels,
                     syncs=sum(sync_at.values()), sync_at=dict(sync_at)))
    print(f"[stage] {name}: host {host_ms:.2f} ms (enqueue {t_enqueue * 1e3:.2f}), device "
          f"busy {dev_us / 1e3:.2f} ms, {kernels} kernels, {sum(sync_at.values())} syncs "
          f"{dict(sync_at) if sync_at else ''}", flush=True)
    return out


def _event_stages(m, st, cfg, frame, cam, ext, gw, noise, rows, ba_name, p):
    """One keyframe event stage by stage, then whole; the branch of its BA
    follows `st` (visual window BA before VI init, inverse-depth after)."""
    from mc_slam_tpu_torch.pipeline import mapping, mapping_ctl
    slot = st.last_kf_slot
    hists = torch.zeros((m.K, 1), device=m.mp_pos.device)
    m1 = measure("pre: cull_and_evict", lambda: mapping.cull_and_evict(
        m, frame, min_obs=cfg.cull_min_obs, n_evict=int(0.07 * m.P)), rows)
    nb4, nbv4, wslots, wvalid = measure(
        "pre: kf_neighbors", lambda: mapping.kf_neighbors(m1, slot, covis_th=cfg.covis_th),
        rows)
    m2, _ = measure("pre: create_points x4 neighbours",
                    lambda: mapping.create_points_with_neighbor_scan(
                        m1, slot, nb4, cam, ext, p.max_new, cfg.n_levels), rows)
    m3, _ = measure("pre: fuse_neighbors (8 pairs)",
                    lambda: mapping.fuse_neighbors(m2, slot, nb4, nbv4, cam, ext), rows)
    m4, ba = measure(ba_name, lambda: mapping_ctl.local_ba(m3, st, cfg, cam, ext, gw, noise,
                                                           ba_Pw=p.ba_Pw), rows)
    m5 = measure("post: refresh_point_stats",
                 lambda: mapping.refresh_point_stats(m4, wslots, wvalid, ext, cfg.n_levels), rows)
    measure("post: stats + covisibility (refresh off)",
            lambda: mapping.kf_event_post(m5, slot, wslots, wvalid, ext, hists, cfg.n_levels,
                                          refresh=False), rows)
    measure("whole event (keyframe_event: with the stats copy and keyframe culling)",
            lambda: mapping_ctl.keyframe_event(m, copy.deepcopy(st), cfg, frame, cam, ext, gw,
                                               noise, max_new=p.max_new, ba_Pw=p.ba_Pw), rows)
    return ba


def profile_bootstrap(chip_smoke, dev, smi, out):
    """Stage tables of the bootstrap path (see the module docstring)."""
    from mc_slam_tpu_torch import camera as tcam
    from mc_slam_tpu_torch.frontend import extractor
    from mc_slam_tpu_torch.imu.preintegration import PreintState, preintegrate_batch
    from mc_slam_tpu_torch.pipeline import (mapping, mapping_ctl, system, tracking,
                                            viinit, viinit_ctl)
    from mc_slam_tpu_torch.slam_map.mapstate import empty_map
    p = dataclasses.replace(chip_smoke.EUROC, n_vi_frames=1)
    seq = chip_smoke.make_sequence(
        dataclasses.replace(p, n_frames=p.boot_max_frame + 2), seed=0)
    cam = chip_smoke.profile_camera(p, dev)
    ext = chip_smoke.factors.extrinsics_from_Tbc(chip_smoke.TBC, device=dev)
    noise = chip_smoke.euroc_noise(device=dev)
    with chip_smoke.capture_bootstrap_states() as cap:
        res = chip_smoke.run_bootstrap(seq, p, cam, dev)
    cfg = chip_smoke.slam_config(p)
    gw0 = torch.tensor([0.0, 0.0, -cfg.g_mag], device=dev)
    rows = []
    measure("profiler warm-up (not a stage)", lambda: mapping.cull_and_evict(cap["events"][0][0], 0), [])

    # ---- two-view initialization and one visual frame ----
    def feats(i):
        f = extractor.extract(torch.from_numpy(seq.imgs[i]).to(dev), n_features=p.n_feat,
                              n_levels=p.n_levels)
        return f, tcam.undistort_points(cam, f.xy)
    (f0, uv0), (f1, uv1) = feats(0), feats(res["init"]["frame"])
    imu1 = torch.from_numpy(np.ascontiguousarray(seq.imu[1])).to(dev)

    def two_view():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return system.try_initialize(
            empty_map(p.max_kf, p.max_mp, p.n_feat, device=dev), mapping_ctl.MappingState(),
            cfg, cam, ext, noise, (f0, uv0, 0.0), f1, uv1, float(seq.times[1]), 1, imu1,
            generator=gen)
    two_view()
    measure("try_initialize (match, 200 hypotheses, 2 keyframes, points, two-view BA)",
            two_view, rows)
    m_e, st_e, frame_e = [c for c in cap["events"] if not c[1].vi_inited][-1]
    z = torch.zeros
    measure("frame_pipeline_visual (one frame against the visual map)",
            lambda: tracking.frame_pipeline_visual(
                m_e, torch.from_numpy(seq.imgs[frame_e]).to(dev), cam, ext,
                m_e.kf_ns.P[st_e.last_kf_slot], m_e.kf_ns.R[st_e.last_kf_slot], z(3, device=dev),
                torch.eye(3, device=dev), z(p.n_feat, dtype=torch.int32, device=dev) - 1,
                z(p.n_feat, device=dev), st_e.last_kf_slot, cfg.min_track_inliers,
                n_features=p.n_feat, n_levels=p.n_levels, iters=p.iters, has_prev=False), rows)

    # ---- the last visual keyframe event ----
    print(f"[event] visual keyframe {st_e.last_kf_slot} at frame {frame_e}: "
          f"{int(m_e.mp_active.sum())} active points, {len(st_e.kf_slots)} keyframes", flush=True)
    mapping_ctl.keyframe_event(m_e, copy.deepcopy(st_e), cfg, frame_e, cam, ext, gw0, noise,
                               max_new=p.max_new, ba_Pw=p.ba_Pw)
    ba_e = _event_stages(m_e, st_e, cfg, frame_e, cam, ext, gw0, noise, rows,
                         "BA: visual_ba window (10 iterations, 2 rounds, full point table)", p)

    # ---- the accepted VI initialization ----
    m_v, st_v, t_v, traj_v = cap["vi_attempts"][-1]
    act = list(st_v.kf_slots)
    print(f"[vi-init] t {t_v:.2f} s, {len(act)} keyframes, {int(m_v.mp_active.sum())} active "
          f"points", flush=True)
    fresh = lambda: copy.deepcopy(st_v)
    m_b, _ = measure("vi-init: whole-map visual BA (10 iterations, 1 round)",
                     lambda: mapping_ctl.local_ba(m_v, fresh(), cfg, cam, ext, gw0, noise,
                                                  force_all=True), rows)
    ks = torch.as_tensor(act, device=dev)
    Rbc = ext.Rcb.T
    pbc = -(Rbc @ ext.tcb)
    Rwc = m_b.kf_ns.R[ks] @ Rbc
    Pwc = m_b.kf_ns.P[ks] + m_b.kf_ns.R[ks] @ pbc
    valid = torch.ones(len(act), device=dev)
    valid[0] = 0.0
    pre = PreintState(*[a[ks] for a in m_b.kf_preint])
    vi = measure("vi-init: try_init_vio (4 steps)",
                 lambda: viinit.try_init_vio(Pwc, Rwc, pre, valid, ext.Rcb, ext.tcb,
                                             g_mag=cfg.g_mag), rows)
    raws = [st_v.kf_imu_raw[s] for s in act if s in st_v.kf_imu_raw]
    T = max(r.shape[0] for r in raws)
    raw = torch.stack([torch.nn.functional.pad(r, (0, 0, 0, T - r.shape[0])) for r in raws])
    measure(f"vi-init: preintegrate_batch ({len(raws)} keyframes x {T} rows)",
            lambda: preintegrate_batch(raw, vi.bg, vi.ba, noise), rows)
    m_i, att = viinit_ctl.maybe_vi_init(m_v, fresh(), cfg, t_v, cam, ext, gw0, noise)
    st_i = fresh()
    st_i.vi_inited = True
    measure("vi-init: whole-map VI BA (8 iterations, 1 round) on the initialized map",
            lambda: mapping_ctl.local_ba(m_i, st_i, cfg, cam, ext, att.gw, noise,
                                         force_all=True), rows)
    measure("vi-init: maybe_vi_init whole",
            lambda: viinit_ctl.maybe_vi_init(m_v, fresh(), cfg, t_v, cam, ext, gw0, noise,
                                             traj=copy.deepcopy(traj_v)), rows)
    result = {"card": smi, "path": "bootstrap", "event_frame": frame_e,
              "event_n_landmarks": int(ba_e.n_landmarks), "vi_init_keyframes": len(act),
              "vi_init_scale": att.scale, "stages": rows}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


def profile_revisit(chip_smoke, dev, smi, out):
    """Stage tables of a relocalization attempt, the bias window's solve and
    a loop event (see the module docstring)."""
    from mc_slam_tpu_torch.frontend import bow
    from mc_slam_tpu_torch.pipeline import mapping, tracking, tracking_ctl
    p = chip_smoke.EUROC_SYSTEM
    seq = chip_smoke.make_sequence(
        dataclasses.replace(chip_smoke.EUROC, n_frames=chip_smoke.EUROC_SYSTEM_FRAMES),
        seed=0, n_depth=0)
    cam = chip_smoke.profile_camera(p, dev)
    res = chip_smoke.run_bootstrap(seq, p, cam, dev)
    slam = res["slam"]
    slam.global_refine()
    cfg, ext, det = slam.cfg, slam.ext, slam.loop
    attempts, window = [], []
    orig = (tracking_ctl.relocalize, tracking_ctl.recompute_bias_from_window)

    def spy_reloc(m, st, cfg_, ts, det_, feats, uv, t, *a, **k):
        attempts.append((m, copy.deepcopy(st), copy.copy(ts), feats, uv, t))
        return orig[0](m, st, cfg_, ts, det_, feats, uv, t, *a, **k)

    def spy_window(m, ts, *a, **k):
        window.append((m, copy.copy(ts)))
        return orig[1](m, ts, *a, **k)

    tracking_ctl.relocalize, tracking_ctl.recompute_bias_from_window = spy_reloc, spy_window
    try:
        rv = chip_smoke.run_revisit(res, seq, p, chip_smoke.REVISIT_SRC,
                                    chip_smoke.REVISIT_FRAMES)
    finally:
        tracking_ctl.relocalize, tracking_ctl.recompute_bias_from_window = orig
    chip_smoke.check_revisit(rv, p)
    rows = []
    measure("profiler warm-up (not a stage)", lambda: mapping.cull_and_evict(slam.m, 0), [])
    gen = lambda: torch.Generator(device=dev).manual_seed(0)

    def attempt(i):
        m, st, ts, feats, uv, t = attempts[i]
        return lambda: orig[0](m, copy.deepcopy(st), cfg, copy.copy(ts), det, feats, uv, t, cam,
                               ext, generator=gen())
    measure("relocalize: a failed attempt (a blank frame; its 5 candidates fail PnP)",
            attempt(0), rows)
    hit = measure("relocalize: the successful attempt, whole", attempt(-1), rows)
    m, st, ts, feats, uv, t = attempts[-1]
    q = measure("reloc: bow_histogram (1024 x 32768 words, top-4) + scores of 512 slots",
                lambda: det.hists @ bow.bow_histogram(feats.desc_pm1, feats.valid.float(),
                                                      det.vocab, idf=det.idf), rows)
    cand = torch.as_tensor(([hit["kf"]] * 5), dtype=torch.int64, device=dev)
    xn = tracking_ctl._normalized(cam, uv)
    packed = measure(f"reloc: reloc_candidates_batch (5 x mutual match + {tracking.PNP_ITERS} "
                     f"PnP hypotheses)",
                     lambda: tracking.reloc_candidates_batch(
                         m, cand, None, feats.desc_pm1, feats.valid, feats.angle, xn, cam.fx,
                         generator=gen()), rows)
    P_b, R_b = tracking_ctl._pnp_to_body(ext, packed[0, 3:12].reshape(3, 3), packed[0, 12:15])
    measure("reloc: track_frame_visual from the PnP pose (15 px, 4 px; 2 kernel launches)",
            lambda: tracking.track_frame_visual(m, feats, uv, cam, ext, P_b, R_b,
                                                radius_coarse=15.0), rows)
    # how often a relocalization attempt succeeds, by the number of PnP
    # hypotheses a candidate: 8 generator seeds on each of the first 5 replayed
    # frames, from the LOST state (whole attempts: any of the 5 candidates)
    from mc_slam_tpu_torch import camera as tcam
    from mc_slam_tpu_torch.frontend import extractor
    m_l, st_l, ts_l = attempts[0][:3]
    reloc_rate, default_hyp = {}, tracking.PNP_ITERS
    study = []
    for src in range(chip_smoke.REVISIT_SRC, chip_smoke.REVISIT_SRC + 5):
        f_s = extractor.extract(torch.from_numpy(seq.imgs[src]).to(dev), n_features=p.n_feat,
                                n_levels=p.n_levels)
        study.append((f_s, tcam.undistort_points(cam, f_s.xy)))
    try:
        for n_hyp in (256, 1024, 2048, 4096):
            tracking.PNP_ITERS = n_hyp
            hits = [orig[0](m_l, copy.deepcopy(st_l), cfg, copy.copy(ts_l), det, f_s, uv_s, 0.0,
                            cam, ext, generator=torch.Generator(device=dev).manual_seed(seed))
                    is not None for f_s, uv_s in study for seed in range(8)]
            reloc_rate[n_hyp] = dict(attempts=len(hits), relocalized=sum(hits))
            print(f"[pnp] {n_hyp} hypotheses a candidate: {sum(hits)} of {len(hits)} attempts "
                  f"relocalized (frames {chip_smoke.REVISIT_SRC}.."
                  f"{chip_smoke.REVISIT_SRC + 4} x 8 seeds)", flush=True)
    finally:
        tracking.PNP_ITERS = default_hyp
    m_w, ts_w = window[-1]
    measure("bias window: recompute_bias_from_window (20 frames, 10 LM iterations)",
            lambda: orig[1](m_w, copy.copy(ts_w), cam, ext, slam.noise), rows)

    st = slam.st
    src_end = chip_smoke.REVISIT_SRC + chip_smoke.REVISIT_FRAMES - 1
    spread = [s for s in rv["kf_before"] if st.kf_id_host[s] > src_end]
    lp = chip_smoke.run_loop_phase(slam, rv["new_kf"], spread)
    for name, fn in chip_smoke.loop_stage_replays(slam, lp):
        fn()
        measure("loop: " + name, fn, rows)
    result = {"card": smi, "path": "revisit", "reloc": rv["reloc"],
              "reloc_source_frame": rv["src_reloc"], "loop": lp["closed"],
              "loop_keyframes": len(st.kf_slots), "relocalized_by_hypotheses": reloc_rate,
              "stages": rows}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


def profile_depth(chip_smoke, dev, smi, out):
    """Stage tables of a stereo VI frame and a keyframe event with the XYZ
    window VI BA (see the module docstring)."""
    from mc_slam_tpu_torch import camera as tcam
    from mc_slam_tpu_torch.frontend import extractor, stereo
    from mc_slam_tpu_torch.pipeline import mapping, mapping_ctl, tracking_ctl
    p = chip_smoke.EUROC
    seq = chip_smoke.make_sequence(dataclasses.replace(p, n_frames=p.boot_max_frame + 30),
                                   seed=0, n_depth=0)
    cam = chip_smoke.profile_camera(p, dev)
    right = chip_smoke.render_right(seq, p, range(len(seq.imgs)))
    vi_frames = []
    orig = tracking_ctl.track_vi

    def spy(m, st, cfg, ts, *a, **k):
        if k.get("depth") is not None and len(vi_frames) < 2:
            vi_frames.append((m, copy.deepcopy(st), copy.deepcopy(ts), a, dict(k)))
        return orig(m, st, cfg, ts, *a, **k)

    tracking_ctl.track_vi = spy
    try:
        with chip_smoke.capture_bootstrap_states() as cap:
            res = chip_smoke.run_depth(seq, p, cam, dev, right=right)
    finally:
        tracking_ctl.track_vi = orig
    chip_smoke.check_depth(res, seq, stereo=True)
    slam = res["slam"]
    cfg, ext, noise = slam.cfg, slam.ext, slam.noise
    rows = []
    measure("profiler warm-up (not a stage)", lambda: mapping.cull_and_evict(slam.m, 0), [])

    # ---- one stereo VI frame ----
    m_f, st_f, ts_f, a_f, k_f = vi_frames[-1]
    img, t = a_f[0], a_f[1]
    i = int(round(t * p.fps))
    img_l = torch.from_numpy(seq.imgs[i]).to(dev)
    img_r = torch.from_numpy(right[i]).to(dev)
    ex = lambda im: extractor.extract(im, n_features=p.n_feat, n_levels=p.n_levels)
    fL = measure("stereo frame: extract left (1024 features, 8 levels)", lambda: ex(img_l), rows)
    fR = measure("stereo frame: extract right", lambda: ex(img_r), rows)
    uvL, uvR = tcam.undistort_points(cam, fL.xy), tcam.undistort_points(cam, fR.xy)
    measure("stereo frame: stereo_depth (1024 x 1024 gated match + mutual check)",
            lambda: stereo.stereo_depth(uvL, fL.desc_pm1, fL.valid, uvR, fR.desc_pm1, fR.valid,
                                        cam.fx, cfg.stereo_baseline), rows)
    fd = measure("stereo frame: SlamSystem._frame_depth whole (right extraction, stereo_depth, "
                 "u_right)", lambda: slam._frame_depth(fL, uvL, None, img_r), rows)
    k_run = dict(k_f, frame=(fL, uvL), depth=fd, allow_kf=False, loop=None, event_timer=None)
    measure("stereo frame: track_vi (VI tracker with the u_right rows, no keyframe)",
            lambda: orig(m_f, copy.deepcopy(st_f), cfg, copy.deepcopy(ts_f), *a_f, **k_run),
            rows)

    # ---- one keyframe event after VI init: the XYZ window VI BA ----
    m_e, st_e, frame_e = [c for c in cap["events"] if c[1].vi_inited][-1]
    print(f"[event] keyframe {st_e.last_kf_slot} at frame {frame_e}: {int(m_e.mp_active.sum())} "
          f"active points, {len(st_e.kf_slots)} keyframes", flush=True)
    gw = slam.gw
    # one untimed pass first (allocator, solver handles)
    mapping_ctl.keyframe_event(m_e, copy.deepcopy(st_e), cfg, frame_e, cam, ext, gw, noise,
                               max_new=p.max_new, ba_Pw=p.ba_Pw)
    ba = _event_stages(m_e, st_e, cfg, frame_e, cam, ext, gw, noise, rows,
                       "BA: XYZ window VI BA (vi_ba with u_right rows, 8 iterations, 2 rounds)",
                       p)
    result = {"card": smi, "path": "depth", "vi_frame": i, "event_frame": frame_e,
              "event_n_landmarks": int(ba.n_landmarks), "stages": rows}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("vi", "bootstrap", "revisit", "depth"), default="vi")
    ap.add_argument("--events", type=int, default=3)
    ap.add_argument("--out", type=Path, default=Path("profile_event.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_event: no GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke
    from mc_slam_tpu_torch.pipeline import mapping, mapping_ctl

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    if args.path == "bootstrap":
        return profile_bootstrap(chip_smoke, dev, smi, args.out)
    if args.path == "revisit":
        return profile_revisit(chip_smoke, dev, smi, args.out)
    if args.path == "depth":
        return profile_depth(chip_smoke, dev, smi, args.out)
    p = dataclasses.replace(chip_smoke.EUROC, n_frames=args.events * chip_smoke.EUROC.kf_every + 1)
    seq = chip_smoke.make_sequence(p, seed=0)
    cam = chip_smoke.profile_camera(p, dev)
    ext = chip_smoke.factors.extrinsics_from_Tbc(chip_smoke.TBC, device=dev)
    captured = []
    chip_smoke.run_track_and_map(seq, p, cam, ext, dev,
                                 on_event=lambda m, st, i: captured.append(
                                     (m, copy.deepcopy(st), i)))
    m, st, frame = captured[-1]
    slots = st.kf_slots
    cfg = chip_smoke.slam_config(p)
    noise = chip_smoke.euroc_noise(device=dev)
    gw = torch.tensor([0.0, 0.0, -9.81], device=dev)
    slot = st.last_kf_slot
    print(f"[event] keyframe {slot} at frame {frame}: {int(m.mp_active.sum())} active "
          f"points, window of {len(slots)} keyframes padded to "
          f"{max(cfg.ba_window, cfg.local_window) + 4}", flush=True)

    # one untimed pass first: allocator, cuSOLVER / cuBLAS handles, profiler start-up
    mapping_ctl.keyframe_event(m, copy.deepcopy(st), cfg, frame, cam, ext, gw, noise,
                               max_new=p.max_new, ba_Pw=p.ba_Pw)
    rows = []
    measure("profiler warm-up (not a stage)", lambda: mapping.cull_and_evict(m, frame), [])
    ba = _event_stages(m, st, cfg, frame, cam, ext, gw, noise, rows,
                       "BA: window_vi_ba_map (8 iterations)", p)
    result = {"card": smi, "frame": frame, "slot": slot, "n_landmarks": int(ba.n_landmarks),
              "stages": rows}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
