"""One run of one cell: `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`.

Prints, as the last lines on standard error, each number the correctness
check compared beside its limit, and as the last line on standard output
one JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`
(with `--trace 1` also `breakdown`), and the compared numbers last.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys

import torch

from benchmark.harness import manifest as mf
from benchmark.harness.trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "mc_slam_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w():
    """The first card's power limit from nvidia-smi."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    return float(line)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start, device=None, spec=None, step_wrapper=None):
    """Run the cell; returns the exit code. `device` and `spec` (the
    resolved cell) are for tests on the CPU: without them the run takes the
    manifest's cell and the card, and stops when the card is missing."""
    args = parse(argv)
    if spec is None:
        spec = mf.resolve_cell(mf.load_manifest(), args.workload)
    if device is None:
        chips = spec["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.set_num_threads(2)
    runner = importlib.import_module(f"benchmark.runners.{spec['config']['runner']}")
    res = runner.run(spec, args.seed % 2 ** 63, args.seconds, bool(args.trace), device,
                     t_start, step_wrapper=step_wrapper)

    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec["workload"]["chips"] if cuda else 1,
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    metrics, line = {}, {}
    if args.trace:
        events, window_s, extra = res["trace"]
        extra["power_limit_w"] = dev.get("power_limit_w", 700.0)
        tr = Trace(events, window_s, extra)
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = window_s
        for m in spec["per_layer"]:
            v = mf.metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        host = Trace(extra.pop("host_events"), window_s, {})
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": host.idle_gaps()}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}

    limits = spec["cell"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"# {args.workload} seed {args.seed}: {res['steps']} steps, "
          f"{res['window_s']:.3f} s window, setup {res['setup_s']:.3f} s", file=sys.stderr)
    if "note" in res:
        print(f"# {res['note']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    out.update(line)
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
