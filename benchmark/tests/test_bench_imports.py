"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the port. Top-level module names are compared whole: the
port's name begins with the JAX package's."""
import json
import subprocess
import sys
from pathlib import Path

from benchmark.harness.cli import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]

RUN_TINY = """
import json, sys, torch
from benchmark.harness import cli, manifest as mf
from benchmark.tests.tiny import tiny_spec
torch.set_num_threads(2)
for name in [p["name"] for p in mf.load_manifest()["per_layer"]]:
    mf.metric_reader(name)
import benchmark.calibrate
rc = cli.main(["--workload", "multiseq.b11", "--seed", "5", "--seconds", "0.3", "--trace", "1"],
              0.0, device=torch.device("cpu"), spec=tiny_spec())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import benchmark.reference.orb, benchmark.reference.track
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = top_level(RUN_TINY)
    assert "mc_slam_tpu_torch" in names and "benchmark" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = top_level(REFERENCE)
    assert "torch" in names
    assert not names & (set(FORBIDDEN) | {"mc_slam_tpu_torch"})


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mc_slam_tpu_torch_extra", sys)
    assert "mc_slam_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "mc_slam_tpu.frontend", sys)
    assert "mc_slam_tpu" in forbidden_modules()
