"""Readings that the limits of a cell's `correct` are set from, many seeds
in one process (set-up is most of a run):

    python3 -m benchmark.calibrate --workload multiseq.b11 --seeds 11 12 13 --steps 40

For each seed: the cell's set-up, `--steps` steps of the program, then on
the run's own sample the program's gaps to the plain reference (the lower
reading) and the control's: the reference computed with TF32 products, the
nearest precision below the configuration's float32 with TF32 off, put in
the program's place (the upper reading). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.runners import multiseq
from benchmark.harness import manifest as mf


def readings(spec, seed, steps, device):
    """{"program": gaps, "control": gaps} of one seed, with each side's
    frames: [position gap, rotation gap, slots that differ, slots
    associated, its inlier count, the reference's]."""
    cell = multiseq.Cell(spec, seed, device)
    done = [cell.step(k) for k in range(steps)]
    cell.free_program()
    sample = cell.sample(len(done), seed)
    refs = [cell.reference(b, done[k][0]) for b, k in sample]
    sides = {"program": [multiseq.answer(done, b, k) for b, k in sample],
             "control": [cell.reference(b, done[k][0], tf32=True) for b, k in sample]}
    out = {}
    for side, answers in sides.items():
        out[side] = multiseq.gaps(list(zip(answers, refs)), cell.cell["far_gap_mm"])
        out[side + "_frames"] = [[round(v, 6) for v in multiseq.frame_gaps(a, r)[:4]]
                                 + [int(a[3]), int(r[3])] for a, r in zip(answers, refs)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="multiseq.b11")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = mf.resolve_cell(mf.load_manifest(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(spec, seed, args.steps, torch.device("cuda", 0))
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
