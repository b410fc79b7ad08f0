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


SYSTEM_MODULES = ("solver.ba_chunked", "pipeline.pipebase", "pipeline.system",
                  "pipeline.mapping_ctl", "pipeline.tracking_ctl", "pipeline.trajstore",
                  "utils.metrics", "io.euroc", "io.trajectory", "sim.euroc_writer", "settings",
                  "convert", "tools.eval_clone")


@pytest.mark.parametrize("mod", SYSTEM_MODULES)
def test_system_modules_are_covered(mod):
    """Every module of the SlamSystem slice is among those the import test
    walks, names neither jax nor the JAX package in an import line, and
    imports by itself in a fresh interpreter without pulling either in."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                   for l in imports)
    proc = _run(f"import sys, mc_slam_tpu_torch.{mod}\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


PLACE_MODULES = ("lie", "frontend.bow", "geometry.pnp", "geometry.sim3solver",
                 "solver.factors", "solver.sim3opt", "solver.posegraph", "pipeline.tracking",
                 "pipeline.loopclosing", "pipeline.loopctl")


@pytest.mark.parametrize("mod", PLACE_MODULES)
def test_place_recognition_modules_are_covered(mod):
    """Every module of the relocalization / loop-closing slice is among those
    the import test walks, names neither jax nor the JAX package in an import
    line, and imports by itself in a fresh interpreter without pulling either
    in (the vocabulary is read as a data file, not imported)."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert imports and not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                               for l in imports)
    proc = _run(f"import sys, mc_slam_tpu_torch.{mod}\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


PERSIST_MESH_MODULES = ("io.checkpoint", "io.stream", "io.native_loader", "viz.snapshot",
                        "parallel.dist_ba", "parallel.dist_gba", "parallel.dist_posegraph",
                        "bench_problems", "tools.run_euroc", "tools.run_mono",
                        "tools.train_vocab")


@pytest.mark.parametrize("mod", PERSIST_MESH_MODULES)
def test_persistence_io_and_mesh_modules_are_covered(mod):
    """Every module of the checkpoint / host I/O / mesh slice is among those
    the import test walks, names neither jax nor the JAX package in an import
    line, and imports by itself in a fresh interpreter without pulling either
    in (the snapshot imports matplotlib only when it draws)."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert imports and not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                               for l in imports)
    proc = _run(f"import sys, mc_slam_tpu_torch.{mod}\n"
                "bad = [m for m in ('jax', 'mc_slam_tpu', 'matplotlib') if m in sys.modules]\n"
                "assert not bad, bad\n")
    assert proc.returncode == 0, proc.stderr


MULTISEQ_MULTIHOST_MODULES = ("parallel.multiseq", "tools.run_multihost_ba",
                              "parallel.dist_ba")


@pytest.mark.parametrize("mod", MULTISEQ_MULTIHOST_MODULES)
def test_multiseq_and_multihost_modules_are_covered(mod):
    """The batched multi-sequence step and the multi-host Schur tool are among
    the modules the import test walks, name neither jax nor the JAX package
    in an import line, and import by themselves in a fresh interpreter
    without pulling either in."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert imports and not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                               for l in imports)
    proc = _run(f"import sys, mc_slam_tpu_torch.{mod}\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


FRAMELOOP_MODULES = ("pipeline.frameloop", "pipeline.pipebase", "pipeline.tracking",
                     "pipeline.loopctl", "io.stream")


@pytest.mark.parametrize("mod", FRAMELOOP_MODULES)
def test_frame_loop_modules_are_covered(mod):
    """The asynchronous frame loop and the modules it changed are among those
    the import test walks, name neither jax nor the JAX package in an import
    line, and import by themselves in a fresh interpreter without pulling
    either in."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert imports and not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                               for l in imports)
    proc = _run(f"import sys, mc_slam_tpu_torch.{mod}\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


EVAL_TOOL_MODULES = ("tools.eval_clone", "tools.eval_vocab", "tools.make_euroc_clone",
                     "tools.make_readme_table")


@pytest.mark.parametrize("mod", EVAL_TOOL_MODULES)
def test_evaluation_tools_are_covered(mod):
    """The evaluation tools (the profiles, the drift injection and the gate
    of eval_clone, eval_vocab, the clone writer, the robustness table) are
    among the modules the import test walks, name neither jax nor the JAX
    package in an import line, and import by themselves in a fresh
    interpreter without pulling either in."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert imports and not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                               for l in imports)
    proc = _run(f"import sys, mc_slam_tpu_torch.{mod}\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


BENCH_TOOL_MODULES = ("tools.bench", "tools.bench_scaling", "tools.probes")


@pytest.mark.parametrize("mod", BENCH_TOOL_MODULES)
def test_benchmark_tools_are_covered(mod):
    """The ports of bench.py and examples/bench_scaling.py, and the kernel
    probes they share with chip_smoke.py, are among the modules the import
    test walks, name neither jax, the JAX package nor chip_smoke in an
    import line (function-local ones too: those run only on the card), and
    import by themselves in a fresh interpreter without pulling either in."""
    assert f"mc_slam_tpu_torch.{mod}" in _port_modules()
    src = (ROOT / "mc_slam_tpu_torch" / (mod.replace(".", "/") + ".py")).read_text()
    imports = [l.strip() for l in src.splitlines() if l.strip().startswith(("import ", "from "))]
    assert imports and not any("jax" in l or "mc_slam_tpu." in l.replace("mc_slam_tpu_torch", "")
                               or "chip_smoke" in l for l in imports)
    proc = _run(f"import sys, mc_slam_tpu_torch.{mod}\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


def test_graft_entry_torch_imports_no_jax():
    """__graft_entry_torch__.py imports, and runs its entry point, without
    jax or the JAX package."""
    proc = _run("import sys, __graft_entry_torch__ as g\n"
                "fn, args = g.entry(device='cpu')\n"
                "assert float(fn(*args)) > 0\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


def test_vocabulary_loads_without_the_jax_package():
    proc = _run("import sys\n"
                "from mc_slam_tpu_torch.frontend import bow\n"
                "v, idf = bow.load_default_vocab(device='cpu'), bow.load_default_idf('cpu')\n"
                "assert v.shape == (32768, 256) and idf.shape == (32768,)\n"
                "assert 'jax' not in sys.modules and 'mc_slam_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("tool", ["bench_hamming", "profile_event", "eval_clone",
                                  "run_multihost_ba", "eval_vocab", "bench", "bench_scaling"])
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
