"""Import hygiene of the port and the no-fallback contract of chip_smoke.py:
the port imports neither jax nor mc_slam_tpu; chip_smoke.py refuses to run
without a GPU and fails in a directory that holds nothing else."""
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    import mc_slam_tpu_torch
    names = ["mc_slam_tpu_torch"]
    for info in pkgutil.walk_packages(mc_slam_tpu_torch.__path__, "mc_slam_tpu_torch."):
        names.append(info.name)
    return names


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    names = _port_modules() + ["chip_smoke"]
    assert len(names) > 15
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'mc_slam_tpu' or m.startswith('mc_slam_tpu.'))\n"
            "print('BAD', bad)\n"
            "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


NEW_MODULES = ("device", "geometry.triangulation", "solver.ba_vi_idp",
               "pipeline.mapping", "pipeline.mapping_ctl", "tools.bench_hamming",
               "tools.profile_event")


def test_keyframe_event_modules_are_covered():
    """The modules of the keyframe-event slice are among those the import
    test walks."""
    names = _port_modules()
    for mod in NEW_MODULES:
        assert f"mc_slam_tpu_torch.{mod}" in names, mod


BOOTSTRAP_MODULES = ("geometry.init2view", "pipeline.viinit", "pipeline.viinit_ctl",
                     "pipeline.tracking_ctl", "pipeline.trajstore", "pipeline.system",
                     "eval.ate", "solver.ba", "solver.ba_vi", "frontend.matching")


@pytest.mark.parametrize("mod", BOOTSTRAP_MODULES)
def test_bootstrap_modules_are_covered(mod):
    """Every module of the bootstrap slice is among those the import test
    walks, and names neither jax nor the JAX package in an import line."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert imports and not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                               for l in imports)


@pytest.mark.parametrize("tool", ["bench_hamming", "profile_event"])
def test_measurement_tools_refuse_without_gpu(tool):
    proc = subprocess.run([sys.executable, "-m", f"mc_slam_tpu_torch.tools.{tool}"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "no GPU" in proc.stderr


def test_port_sources_never_name_jax():
    for path in (ROOT / "mc_slam_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and not s.split()[1].startswith("mc_slam_tpu."), \
                    (path, line)


def test_chip_smoke_refuses_without_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("device", ["meta"])
def test_wrapper_rejects_devices_without_a_kernel(device):
    import torch
    from mc_slam_tpu_torch.frontend import match_cuda
    args = [torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, 256, dtype=torch.int8),
            torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.bool)]
    args = [a.to(device) for a in args + args]
    with pytest.raises(ValueError):
        match_cuda.hamming_top2_windowed(*args, 4.0)
