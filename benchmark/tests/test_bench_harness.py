"""The harness: the manifest resolves by name, names and units keep the
contract's alphabet, a tiny CPU run prints the result line, and a run whose
timed path is broken underneath reads `correct` false."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import cli
from benchmark.harness import manifest as mf
from benchmark.tests.tiny import tiny_spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_and_config_resolves_to_its_files():
    m = mf.load_manifest()
    assert {c["name"] for c in m["configs"]} == {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in m["workloads"]:
        spec = mf.resolve_cell(m, w["name"])
        assert {"setup_s"} < {e["name"] for e in spec["end_to_end"]}
        assert spec["per_layer"] and set(spec["cell"]["limits"])
        for p in spec["per_layer"]:
            assert callable(mf.metric_reader(p["name"]))


def test_names_and_units_keep_the_alphabet():
    m = mf.load_manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    names += [r for c in m["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for k in ("end_to_end", "per_layer") for x in m[k])) \
        == len(m["end_to_end"]) + len(m["per_layer"])
    assert all(UNIT.match(x["unit"]) for k in ("end_to_end", "per_layer") for x in m[k])
    assert all(w["chips"] in (1, 4) for w in m["workloads"])


def test_no_test_file_name_is_used_in_tests():
    mine = {p.name for p in (ROOT / "benchmark" / "tests").glob("*.py")}
    assert not mine & {p.name for p in (ROOT / "tests").glob("*.py")}


def tiny_run(capsys, trace, step_wrapper=None, seed=2 ** 31 + 77, streams=2):
    torch.set_num_threads(2)
    rc = cli.main(["--workload", "multiseq.b11", "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], 0.0, device=torch.device("cpu"),
                  spec=tiny_spec(streams=streams), step_wrapper=step_wrapper)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cpu_run_prints_the_result_line(capsys, trace):
    line, err = tiny_run(capsys, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert set(line) == set(keys) | {"checks"} | ({"breakdown"} if trace else set())
    assert line["correct"] is True and line["attempted"] > 0
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def unchanged(step):
    """A step that returns its prior pose."""
    def broken(ms, imgs, P0, R0):
        _, _, fmp, n = step(ms, imgs, P0, R0)
        return P0, R0, fmp, n
    return broken


def half_batch(step):
    """A step that tracks the first half of the streams only."""
    from mc_slam_tpu_torch.parallel.multiseq import batch_rows

    def broken(ms, imgs, P0, R0):
        h = imgs.shape[0] // 2
        P, R, fmp, n = step(batch_rows(ms, slice(0, h)), imgs[:h], P0[:h], R0[:h])
        return (torch.cat([P, P0[h:]]), torch.cat([R, R0[h:]]),
                torch.cat([fmp, torch.full_like(fmp, -1)]), torch.cat([n, torch.zeros_like(n)]))
    return broken


def altered(step):
    """A step whose poses are moved 2 mm where they are produced."""
    def broken(ms, imgs, P0, R0):
        P, R, fmp, n = step(ms, imgs, P0, R0)
        return P + torch.tensor([2e-3, 0.0, 0.0]), R, fmp, n
    return broken


def tenth_unchanged(step):
    """A step whose last tenth of the streams keep their prior pose."""
    def broken(ms, imgs, P0, R0):
        P, R, fmp, n = step(ms, imgs, P0, R0)
        k = imgs.shape[0] - max(1, imgs.shape[0] // 10)
        return torch.cat([P[:k], P0[k:]]), torch.cat([R[:k], R0[k:]]), fmp, n
    return broken


def tenth_altered(step):
    """A step whose poses of the last tenth of the streams are moved 2 mm."""
    def broken(ms, imgs, P0, R0):
        P, R, fmp, n = step(ms, imgs, P0, R0)
        k = imgs.shape[0] - max(1, imgs.shape[0] // 10)
        return torch.cat([P[:k], P[k:] + torch.tensor([2e-3, 0.0, 0.0])]), R, fmp, n
    return broken


@pytest.mark.parametrize("fault,streams,caught_by", [
    (unchanged, 2, None), (half_batch, 2, None), (altered, 2, None),
    (tenth_unchanged, 10, "far_frame_pct"), (tenth_altered, 10, "far_frame_pct")])
def test_a_broken_step_reads_not_correct(capsys, fault, streams, caught_by):
    """One stream of ten broken is a tenth of the sample, which the share of
    far frames catches where the 90th percentile does not."""
    line, _ = tiny_run(capsys, 0, step_wrapper=fault, streams=streams)
    assert line["correct"] is False
    if caught_by:
        c = line["checks"][caught_by]
        assert c["value"] > c["limit"], line["checks"]


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "multiseq.b11",
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
