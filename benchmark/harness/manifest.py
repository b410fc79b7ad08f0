"""The benchmark's manifest (`BENCHMARK.json`) and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by its name:
`benchmark/configs/<config>.json`, `benchmark/traffic/<traffic>.json`,
`benchmark/workloads/<cell>.json` and `benchmark/metrics/<metric>.py`.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve_cell(manifest: dict, name: str) -> dict:
    """The cell `name` with everything it needs: its manifest entry, its
    configuration's file, its traffic mix, its own file, and the metrics it
    reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    w = cells[name]
    cfg_file = {c["name"]: c["file"] for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return dict(
        workload=w,
        config=_json(ROOT / cfg_file),
        traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        cell=_json(BENCH / "workloads" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def metric_reader(name: str):
    """The `read(trace)` function of the per-layer metric `name`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
