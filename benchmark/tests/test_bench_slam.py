"""The cell `mono-vi.stream` cut to a size the CPU runs in about a minute a
run (480x360, 512 features, 4 levels, tables of 16 keyframes and 2048
points, a 512-texel world): the result line keeps the contract's keys and
reads `correct` true, and a run whose VI frames hand on a pose, a velocity
or a gyro bias moved where they are produced reads `correct` false."""
import copy
import json

import pytest
import torch

from benchmark.harness import cli
from benchmark.harness import manifest as mf

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_spec():
    spec = copy.deepcopy(mf.resolve_cell(mf.load_manifest(), "mono-vi.stream"))
    cfg = spec["config"]
    c = cfg["camera"]
    sx, sy = 480 / c["width"], 360 / c["height"]
    c.update(fx=c["fx"] * sx, fy=c["fy"] * sy, cx=c["cx"] * sx, cy=c["cy"] * sy,
             width=480, height=360)
    cfg["slam"].update(max_kf=16, max_mp=2048, n_feat=512, n_levels=4, local_window=4)
    cfg["world"].update(tex_size=512)
    spec["cell"].update(warmup_frames=1, lead_kf_gap=0, trace_frames=2, trace_events=0,
                        trace_frames_max=3, host_frames=1, sample=2, vi_init_deadline=160)
    return spec


def tiny_run(capsys, trace, step_wrapper=None, seed=2 ** 31 + 91):
    torch.set_num_threads(2)
    rc = cli.main(["--workload", "mono-vi.stream", "--seed", str(seed), "--seconds", "0.3",
                   "--trace", str(trace)], 0.0, device=torch.device("cpu"), spec=tiny_spec(),
                  step_wrapper=step_wrapper)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cpu_run_prints_the_result_line(capsys, trace):
    line, err = tiny_run(capsys, trace)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line) == set(KEYS) | {"checks"} | ({"breakdown"} if trace else set())
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(tiny_spec()["cell"]["limits"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert "VI frames" in err and "keyframe events" in err
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def moved(field, delta):
    """A VI frame whose answer has `field` of its state moved by `delta`."""
    def wrap(body):
        def broken(*args, **kwargs):
            out = body(*args, **kwargs)
            ns = out[2]
            ns = ns._replace(**{field: getattr(ns, field) + torch.tensor(delta)})
            return out[:2] + (ns,) + out[3:]
        return broken
    return wrap


@pytest.mark.parametrize("field,delta,caught_by", [
    ("P", [2e-3, 0.0, 0.0], "pose_gap_mm.p90"),
    ("V", [0.0, 0.05, 0.0], "vel_gap_mm_s.p90"),
    ("dbg", [0.0, 0.0, 2e-3], "bg_gap_mrad_s.p90")])
def test_a_vi_frame_moved_where_it_is_produced_reads_not_correct(capsys, field, delta,
                                                                 caught_by):
    """2 mm, 50 mm/s and 2 mrad/s: each over its limit, so the sampled
    frame's gap to the reference catches it."""
    line, _ = tiny_run(capsys, 0, step_wrapper=moved(field, delta))
    assert line["correct"] is False
    c = line["checks"][caught_by]
    assert c["value"] > c["limit"], line["checks"]


REFERENCE_VI = """
import json, sys
import benchmark.reference.vi, benchmark.reference.vi_frame
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

RUNNER = """
import json, sys
from benchmark.harness import manifest as mf
import benchmark.runners.slam, benchmark.calibrate_slam
for p in mf.load_manifest()["per_layer"]:
    mf.metric_reader(p["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("code,port_free", [(REFERENCE_VI, True), (RUNNER, False)])
def test_the_reference_and_the_runner_load_no_jax(code, port_free):
    """The VI reference loads nothing of the port; the runner, the
    calibration and the readers load no module of JAX or the JAX package
    (top-level names compared whole; a tiny run checks what the port loads,
    `cli.main` refusing a run that loaded one)."""
    from benchmark.harness.cli import FORBIDDEN
    from benchmark.tests.test_bench_imports import top_level
    names = top_level(code)
    assert "torch" in names and not names & set(FORBIDDEN)
    if port_free:
        assert "mc_slam_tpu_torch" not in names
