"""Readings that the limits of a slam cell's `correct` are set from, many
seeds in one process (the cold start is most of a run):

    python3 -m benchmark.calibrate_slam --workload mono-vi.stream --seeds 11 12 --frames 24

For each seed: the cell's set-up, `--frames` VI frames of the program with
the recorder on, then on the run's own sample the program's gaps to the
plain reference (the lower reading) and the control's: the reference
computed with TF32 products, the nearest precision below the
configuration's float32 with TF32 off, put in the program's place (the
upper reading); beside them the run's `ate_mm` and `vi_scale_err_pct`, and
each sampled frame's gaps. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.harness import manifest as mf
from benchmark.runners import slam


def readings(spec, seed, frames, device):
    cell = slam.Cell(spec, seed, device, seconds=frames / spec["config"]["camera"]["fps"])
    try:
        t0 = time.perf_counter()
        scale_err = cell.cold_start()
        cold_s, k_vi = time.perf_counter() - t0, cell.k
        cell.paced(spec["cell"]["warmup_frames"])
        before, k0 = cell.counters(), cell.k
        cell.recorder.on = True
        n, failed, window_s = cell.paced(frames)
        cell.recorder.on = False
        out = dict(cold_start_s=cold_s, vi_init_frame=k_vi, frames=n, failed=failed,
                   frame_s=window_s / n, note=slam.note(cell, before, k0, cell.k),
                   ate_mm=cell.ate_mm(k0, cell.k), vi_scale_err_pct=scale_err)
        sample = cell.sample(seed)
        refs = [cell.reference(x) for x, _ in sample]
        sides = {"program": [slam.program_answer(o) for _, o in sample],
                 "control": [cell.reference(x, tf32=True) for x, _ in sample]}
        for side, answers in sides.items():
            out[side] = slam.gaps(list(zip(answers, refs)))
            out[side + "_frames"] = [[round(v, 9) for v in slam.frame_gaps(a, r)[:6]]
                                     + [a["n_inliers"], r["n_inliers"], a["fallback"],
                                        r["fallback"]] for a, r in zip(answers, refs)]
        return out
    finally:
        cell.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="mono-vi.stream")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_slam: no CUDA device", file=sys.stderr)
        return 2
    spec = mf.resolve_cell(mf.load_manifest(), args.workload)
    torch.set_num_threads(2)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(spec, seed, args.frames, torch.device("cuda", 0))
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
