"""Time variants of the hamming_top2_windowed kernel on one GPU, in turns.

    python3 -m mc_slam_tpu_torch.tools.bench_hamming [--baseline OLD.cu]
        [--variants 8x256x4,32x256x4,...] [--batch B] [--out bench_hamming.json]

Builds csrc/hamming_top2_windowed.cu once per variant GROUPxTHREADSxUNROLL
(the source's HT2W_GROUP / HT2W_THREADS / HT2W_UNROLL macros; one nvcc per
variant, all started together), and optionally another source with the same
C entry point as a baseline. Every build is held exactly against the plain
PyTorch twin at M=16384 x N=1024 and the ragged 16001 x 1000, radii 4, 15 and
40 px, on chip_smoke.planted_inputs. Then each is timed at 16384 x 1024:

* warm (probes.time_cuda): 200 launches queued behind a device-side
  sleep, so the host's enqueue time is hidden and the card runs them back to
  back; CUDA events around the batch, divided by its count. Variants take
  turns (a, b, ..., b, a) and the median over rounds is kept.
* cold (probes.time_cuda_cold): a pass over a 256 MB buffer between
  launches evicts the 50 MB L2; CUDA events around each single launch, median.
* wrapper: the shipped build through match_cuda.hamming_top2_windowed, warm,
  Python wrapper included.
* --batch B: B problems of 16384 x 1024 (planted_inputs(batch=B)) in ONE
  launch of the shipped build through the wrapper, held exactly against the
  batched twin, then timed warm and cold as above, beside B x the single
  problem's wrapper time and the batched bound (chip_smoke.search_bound).

Needs a GPU; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from mc_slam_tpu_torch.frontend import match_cuda
from mc_slam_tpu_torch.tools import probes
from mc_slam_tpu_torch.utils import cuda_build

RADII = (4.0, 15.0, 40.0)
ARG_KEYS = ("a_desc", "a_uv", "a_lvl", "a_valid", "b_desc", "b_uv", "b_lvl", "b_valid")


def start_build(source: Path, defines: dict, out_dir: Path):
    flags = [*cuda_build.NVCC_FLAGS, *[f"-D{k}={v}" for k, v in defines.items()]]
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    lib = out_dir / f"libvariant_{key}.so"
    proc = subprocess.Popen([cuda_build.find_nvcc(), *flags, "-o", str(lib), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def load(lib: Path):
    fn = ctypes.CDLL(str(lib)).hamming_top2_windowed_launch
    p = ctypes.c_void_p
    fn.argtypes = [p] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


class Raw:
    """One built variant with preallocated outputs: launch() enqueues only."""

    def __init__(self, fn, inp, radius):
        self.fn, self.radius = fn, radius
        self.M, self.N = inp["a_desc"].shape[0], inp["b_desc"].shape[0]
        self.ptrs = [inp[k].data_ptr() for k in ARG_KEYS]
        self.keep = inp
        self.outs = [torch.empty(self.M, dtype=torch.int32, device="cuda") for _ in range(3)]
        self.stream = torch.cuda.current_stream().cuda_stream

    def launch(self):
        err = self.fn(*self.ptrs, self.radius, 1, self.M, self.N,
                      *[o.data_ptr() for o in self.outs], self.stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")


def check_exact(fn, inp, radius):
    raw = Raw(fn, inp, radius)
    raw.launch()
    torch.cuda.synchronize()
    ref = match_cuda.hamming_top2_windowed_ref(
        inp["a_pm1"], inp["a_uv"], inp["a_lvl"], inp["a_valid"], inp["b_pm1"],
        inp["b_uv"], inp["b_lvl"], inp["b_valid"], radius)
    has = ref[0] < match_cuda.BIG
    if not torch.equal(raw.outs[0], ref[0]):
        raise AssertionError("best differs")
    if not torch.equal(raw.outs[1][has], ref[1][has]):
        raise AssertionError("second differs")
    if not torch.equal(raw.outs[2][has], ref[2][has]):
        raise AssertionError("idx differs")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variants", default="8x256x4")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=0,
                    help="also time B problems in one launch (0: no)")
    ap.add_argument("--out", type=Path, default=Path("bench_hamming.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_hamming: no GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    smi = probes.card_line()
    print(smi, flush=True)
    out_dir = cuda_build.BUILD_ROOT / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for v in args.variants.split(","):
        g, t, u = (int(x) for x in v.split("x"))
        builds[v] = start_build(match_cuda._SOURCE, {"HT2W_GROUP": g, "HT2W_THREADS": t,
                                                      "HT2W_UNROLL": u}, out_dir)
    if args.baseline is not None:
        builds["baseline"] = start_build(args.baseline, {}, out_dir)
    fns = {}
    for name, (lib, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"[build] {name}: {' | '.join(log.strip().splitlines()[-3:])}", flush=True)
        fns[name] = load(lib)

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    big = chip_smoke.planted_inputs(16384, 1024, rng, dev)
    ragged = chip_smoke.planted_inputs(16001, 1000, rng, dev)
    for name, fn in fns.items():
        for inp in (big, ragged):
            for r in RADII:
                check_exact(fn, inp, r)
        print(f"[exact] {name}: kernel == twin at both shapes, radii {RADII}", flush=True)

    flush = torch.zeros(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    result = {"card": smi, "warm_ms": {}, "cold_ms": {}}
    names = list(fns)
    for r in RADII:
        raws = {n: Raw(fns[n], big, r) for n in names}
        warm = {n: [] for n in names}
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                warm[n].append(probes.time_cuda(raws[n].launch, n=200, rounds=1))
        cold = {n: probes.time_cuda_cold(raws[n].launch, flush, n=30) for n in names}
        for n in names:
            result["warm_ms"].setdefault(n, {})[f"{r:g}"] = statistics.median(warm[n])
            result["cold_ms"].setdefault(n, {})[f"{r:g}"] = cold[n]
            print(f"[time] r={r:g} {n}: warm {statistics.median(warm[n]) * 1e3:.2f} us "
                  f"(min {min(warm[n]) * 1e3:.2f}, max {max(warm[n]) * 1e3:.2f}), "
                  f"cold L2 {cold[n] * 1e3:.2f} us", flush=True)

    # the shipped build through the Python wrapper
    wargs = [big[k] for k in ("a_desc", "a_pm1", "a_uv", "a_lvl", "a_valid",
                              "b_desc", "b_pm1", "b_uv", "b_lvl", "b_valid")]
    result["wrapper_ms"] = {
        f"{r:g}": probes.time_cuda(lambda: match_cuda.hamming_top2_windowed(*wargs, r))
        for r in RADII}
    print(f"[time] wrapper: {result['wrapper_ms']}", flush=True)
    if args.batch:
        B = args.batch
        inp = chip_smoke.planted_inputs(16384, 1024, rng, dev, batch=B)
        bargs = [inp[k] for k in ("a_desc", "a_pm1", "a_uv", "a_lvl", "a_valid",
                                  "b_desc", "b_pm1", "b_uv", "b_lvl", "b_valid")]
        batched = {"B": B, "warm_ms": {}, "cold_ms": {}, "bound_ms": {}}
        for r in RADII:
            chip_smoke.compare_kernel(inp, r)
            batched["warm_ms"][f"{r:g}"] = probes.time_cuda(
                lambda: match_cuda.hamming_top2_windowed(*bargs, r))
            batched["cold_ms"][f"{r:g}"] = probes.time_cuda_cold(
                lambda: match_cuda.hamming_top2_windowed(*bargs, r), flush, n=30)
            batched["bound_ms"][f"{r:g}"] = chip_smoke.search_bound(inp, r)[0]
            print(f"[batch] B={B} r={r:g}: exact; one launch warm "
                  f"{batched['warm_ms'][f'{r:g}'] * 1e3:.2f} us, cold "
                  f"{batched['cold_ms'][f'{r:g}'] * 1e3:.2f} us; {B} x single "
                  f"{B * result['wrapper_ms'][f'{r:g}'] * 1e3:.2f} us; bound "
                  f"{batched['bound_ms'][f'{r:g}'] * 1e3:.2f} us", flush=True)
        result["batched"] = batched
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
