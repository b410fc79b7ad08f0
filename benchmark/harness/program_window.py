"""A traced window with the program's own spans on, and its reading on the card.

`traced_with_spans(fn, steps, device)` runs fn(k) under the profiler with the
device alone, as the runner's first window does (`trace.traced`), but with a
`StageTimer` of the program made active (`mc_slam_tpu_torch.utils.metrics
.tracing`): the spans the batched step opens (`multiseq.step`,
`frontend.extract`, `tracking.search`, `tracking.solve`) leave their records,
stamped on the clock of the profiler's events, for
`benchmark/metrics/_spans.py`. The runner's own windows run with no active
timer, so none of the program's spans enters them.

    python3 -m benchmark.harness.program_window --seeds 7 8 --out spans.json

builds the cell `multiseq.b11` on the card for each seed and prints one JSON
object a seed: the launches a step that the host issued and the device
records of them in a window without the spans and in the window with them
(the profiler drops a device record at times), that window read by `_spans`
(launches, device ms and idle ms a step of each span and of the whole), the
stages' shares of the launches and of the idle time, the operations that
start on the device before their span opened on the host and the lag from a
launch to its start on the device (the profiler's device clock against its
host clock), and, without a profiler, steps per second in interleaved
windows with the program's timer off and on and the host cost of one span.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from benchmark.harness import manifest as mf
from benchmark.harness.trace import traced
from benchmark.metrics._spans import Spans

STAGES = ("frontend.extract", "tracking.search", "tracking.solve")
CLOCK_TOL_NS = 10_000


def traced_with_spans(fn, steps, device):
    """fn(k) for k in range(steps) under the profiler with the device alone
    and a program timer active. Returns (fn's results, the profiler's
    events, the window's host seconds, the timer's records)."""
    from mc_slam_tpu_torch.utils import metrics
    timer = metrics.StageTimer()
    with metrics.tracing(timer):
        outs, events, window_s, _ = traced(fn, steps, device, host_ops=False)
    return outs, events, window_s, timer.records


def device_ops(events):
    """Device events that are not a span's shadow."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.device_type() == cuda and not e.is_user_annotation() for e in events)


def issued(events):
    """Correlation ids of the launches, copies and sets the host issued."""
    return {e.correlation_id() for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA
            and any(k in e.name() for k in ("Launch", "Memcpy", "Memset"))}


def dropped_ops(events):
    """Operations the host issued whose device record the window lacks."""
    cuda = torch.autograd.DeviceType.CUDA
    return len(issued(events) - {e.correlation_id() for e in events if e.device_type() == cuda})


def read_window(cell, start, steps, device):
    """The launches a step of a device-only window with no span, then the
    window with the program's spans, read by `_spans`."""
    _, plain, _, _ = traced(lambda k: cell.step(start + k), steps, device, host_ops=False)
    _, events, window_s, records = traced_with_spans(
        lambda k: cell.step(start + steps + k), steps, device)
    sp = Spans(events, records)
    whole = sp.per_step()
    out = {"steps": steps, "window_s": window_s,
           "issued_per_step": [len(issued(plain)) / steps, len(issued(events)) / steps],
           "device_ops_per_step": [device_ops(plain) / steps, device_ops(events) / steps],
           "dropped_ops": [dropped_ops(plain), dropped_ops(events)],
           "whole": whole, "stages": {n: sp.per_step(n) for n in STAGES},
           "early_ops": sp.early(CLOCK_TOL_NS),
           "unlaunched_ops": sum(t is None for t in sp.launched)}
    lag = sorted((s - t) * 1e-3 for (s, _, _), t in zip(sp.ops, sp.launched) if t is not None)
    if lag:     # device start minus the start of its launch on the host, us
        out["lag_us"] = {"min": lag[0], "p1": lag[len(lag) // 100],
                         "median": lag[len(lag) // 2]}
    if whole:
        st = out["stages"].values()
        out["launch_cover"] = sum(s["launches"] for s in st) / whole["launches"]
        out["idle_cover"] = sum(s["idle_ms"] for s in st) / max(whole["idle_ms"], 1e-12)
    return out


def steps_per_s(cell, seconds, rounds):
    """Steps a second without a profiler in interleaved windows of `seconds`,
    with no timer active ("off") and with a program timer active ("on"),
    which of the two first alternating by round; and each round's on / off."""
    from mc_slam_tpu_torch.utils import metrics
    rates = {"off": [], "on": []}
    k = 0
    for r in range(rounds):
        for mode in ("off", "on") if r % 2 == 0 else ("on", "off"):
            with metrics.tracing(metrics.StageTimer() if mode == "on" else None):
                n, t0 = 0, time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    cell.step(k)
                    k, n = k + 1, n + 1
                rates[mode].append(n / (time.perf_counter() - t0))
    rates["on_over_off"] = [a / b for a, b in zip(rates["on"], rates["off"])]
    out = {}
    for m, xs in rates.items():
        q = statistics.quantiles(xs, n=4)
        med = statistics.median(xs)
        out[m] = {"median": med, "iqr_pct": 100 * (q[2] - q[0]) / med, "runs": xs}
    out["span_us"] = {m: span_us(metrics.StageTimer() if m == "on" else None)
                      for m in ("off", "on")}
    return out


def span_us(timer, n=20000):
    """Host microseconds one empty `span` takes with `timer` active."""
    from mc_slam_tpu_torch.utils import metrics
    with metrics.tracing(timer):
        t0 = time.perf_counter()
        for _ in range(n):
            with metrics.span("x"):
                pass
        return (time.perf_counter() - t0) / n * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="multiseq.b11")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cost-seconds", type=float, default=3.0)
    ap.add_argument("--cost-rounds", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("program_window: needs a CUDA device")
    from benchmark.runners.multiseq import Cell
    device = torch.device("cuda", 0)
    torch.set_num_threads(2)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    spec = mf.resolve_cell(mf.load_manifest(), args.workload)
    results = []
    for seed in args.seeds:
        cell = Cell(spec, seed, device)
        for k in range(spec["cell"]["warmup_steps"]):
            cell.step(k)
        cell.sync()
        res = {"workload": args.workload, "seed": seed, "card": card,
               "window": read_window(cell, 0, spec["cell"]["trace_steps"], device)}
        if args.cost_rounds:
            res["cost"] = steps_per_s(cell, args.cost_seconds, args.cost_rounds)
        print(json.dumps(res), flush=True)
        results.append(res)
        del cell
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
