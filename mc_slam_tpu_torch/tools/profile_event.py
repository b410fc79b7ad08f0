"""Stage table of one keyframe event at the euroc profile's full width.

    python3 -m mc_slam_tpu_torch.tools.profile_event [--events 3]
        [--out profile_event.json]

Runs chip_smoke.py's track-and-map path up to the insertion of keyframe
`--events`, then runs that event stage by stage (the calls of
mapping.kf_event_pre, mapping_ctl.local_ba_idp and mapping.kf_event_post,
in their order), each stage under torch.profiler and with
torch.cuda.set_sync_debug_mode("warn"): host milliseconds (host clock, the
stage ends in a synchronize), device-busy milliseconds (sum of the kernels'
device time), kernels launched, and the device->host synchronizations with
the source lines that caused them. Needs a GPU; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

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
                     device_ms=dev_us / 1e3, kernels=kernels,
                     syncs=sum(sync_at.values()), sync_at=dict(sync_at)))
    print(f"[stage] {name}: host {host_ms:.2f} ms (enqueue {t_enqueue * 1e3:.2f}), device "
          f"busy {dev_us / 1e3:.2f} ms, {kernels} kernels, {sum(sync_at.values())} syncs "
          f"{dict(sync_at) if sync_at else ''}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
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
    p = dataclasses.replace(chip_smoke.EUROC, n_frames=args.events * chip_smoke.EUROC.kf_every + 1)
    seq = chip_smoke.make_sequence(p, seed=0)
    cam = chip_smoke.profile_camera(p, dev)
    ext = chip_smoke.factors.extrinsics_from_Tbc(chip_smoke.TBC, device=dev)
    captured = []
    chip_smoke.run_track_and_map(seq, p, cam, ext, dev,
                                 on_event=lambda m, st, i: captured.append((m, st.kf_slots[:], i)))
    m, slots, frame = captured[-1]
    st = mapping_ctl.MappingState(kf_slots=slots, last_kf_slot=slots[-1])
    cfg = mapping_ctl.MappingConfig(n_levels=p.n_levels, local_window=p.local_window,
                                    max_new=p.max_new, ba_Pw=p.ba_Pw)
    noise = chip_smoke.euroc_noise(device=dev)
    gw = torch.tensor([0.0, 0.0, -9.81], device=dev)
    slot = st.last_kf_slot
    hists = torch.zeros((m.K, 1), device=dev)
    print(f"[event] keyframe {slot} at frame {frame}: {int(m.mp_active.sum())} active "
          f"points, window of {len(slots)} keyframes padded to "
          f"{max(cfg.ba_window, cfg.local_window) + 4}", flush=True)

    # one untimed pass first: allocator, cuSOLVER / cuBLAS handles, profiler start-up
    mapping_ctl.keyframe_event(m, st, cfg, frame, cam, ext, gw, noise)
    rows = []
    measure("profiler warm-up (not a stage)", lambda: mapping.cull_and_evict(m, frame), [])
    m1 = measure("pre: cull_and_evict", lambda: mapping.cull_and_evict(
        m, frame, min_obs=mapping_ctl.CULL_MIN_OBS, n_evict=int(0.07 * m.P)), rows)
    nb4, nbv4, wslots, wvalid = measure(
        "pre: kf_neighbors", lambda: mapping.kf_neighbors(m1, slot, covis_th=mapping_ctl.COVIS_TH),
        rows)
    m2, _ = measure("pre: create_points x4 neighbours",
                    lambda: mapping.create_points_with_neighbor_scan(
                        m1, slot, nb4, cam, ext, cfg.max_new, cfg.n_levels), rows)
    m3, _ = measure("pre: fuse_neighbors (8 pairs)",
                    lambda: mapping.fuse_neighbors(m2, slot, nb4, nbv4, cam, ext), rows)
    m4, ba = measure("BA: window_vi_ba_map (8 iterations)",
                     lambda: mapping_ctl.local_ba_idp(m3, st, cfg, cam, ext, gw, noise), rows)
    m5 = measure("post: refresh_point_stats",
                 lambda: mapping.refresh_point_stats(m4, wslots, wvalid, ext, cfg.n_levels), rows)
    measure("post: stats + covisibility (refresh off)",
            lambda: mapping.kf_event_post(m5, slot, wslots, wvalid, ext, hists, cfg.n_levels,
                                          refresh=False), rows)
    measure("whole event (keyframe_event)",
            lambda: mapping_ctl.keyframe_event(m, st, cfg, frame, cam, ext, gw, noise), rows)
    result = {"card": smi, "frame": frame, "slot": slot, "n_landmarks": int(ba.n_landmarks),
              "stages": rows}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
