"""The port's evaluation tools against the JAX repo's scripts on the CPU:
the standalone clone writer against examples/make_euroc_clone.py (equal
CSVs; frames within one grey level on under 1 % of pixels, the renderer's
tolerance in test_torch_sim.py: the two undistortions round differently),
eval_vocab against examples/eval_vocab.py (per-frame histograms on the JAX
feature tables to 1e-6, test_torch_bow.py's tolerance; both scripts' results
with recall@1 within one frame's share), and the port's robustness table."""
import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mc_slam_tpu.frontend import bow as jbow
from mc_slam_tpu.frontend import extractor as jex
from mc_slam_tpu_torch.frontend import bow as tbow
from mc_slam_tpu_torch.tools import eval_vocab, make_euroc_clone, make_readme_table
from torch_port_helpers import jax_features

ROOT = Path(__file__).resolve().parent.parent
W_CUT = 2048        # the shipped vocabulary cut to its first words (test_torch_bow.py)
N_FEAT = 256


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_clone_writer_matches_jax(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    args = ["--duration", "0.4", "--tex-size", "256"]
    make_euroc_clone.main(["--out", str(tmp_path / "t")] + args)
    monkeypatch.setattr(sys, "argv", ["make_euroc_clone.py", "--out", str(tmp_path / "j")] + args)
    _script("make_euroc_clone").main()
    t, j = tmp_path / "t" / "mav0", tmp_path / "j" / "mav0"
    for rel in ("cam0/data.csv", "imu0/data.csv", "state_groundtruth_estimate0/data.csv"):
        assert (t / rel).read_bytes() == (j / rel).read_bytes(), rel
    names = sorted(p.name for p in (t / "cam0" / "data").iterdir())
    assert len(names) == 8 and names == sorted(p.name for p in (j / "cam0" / "data").iterdir())
    for n in names:
        a = np.asarray(Image.open(t / "cam0" / "data" / n), np.int16)
        b = np.asarray(Image.open(j / "cam0" / "data" / n), np.int16)
        assert a.shape == b.shape == (480, 752)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, n


def test_clone_reader_imu_rows_match_jax_reader(tmp_path):
    """The IMU rows eval_clone feeds the port (from disk, and rendered in
    memory) equal those the JAX script reads through the native loader
    (mc_slam_tpu.io.native_loader), the stream's first sample's 5 ms
    included (ROADMAP F22)."""
    from mc_slam_tpu.io import native_loader as jnative
    from mc_slam_tpu_torch.tools import eval_clone
    if not jnative.available():
        pytest.skip("native/libeuroc_loader.so is not built (make -C native)")
    torch.set_num_threads(2)
    args = ["--duration", "0.4", "--tex-size", "256"]
    make_euroc_clone.main(["--out", str(tmp_path / "t")] + args)
    mav0 = str(tmp_path / "t" / "mav0")
    ref = [(t, r) for t, _, r in jnative.NativeEurocLoader(mav0)]
    disk, _, _ = eval_clone.frames_from_disk(mav0, 0)
    mem, _, _ = eval_clone.frames_in_memory(eval_clone.parse_args(args), len(ref))
    for got in (list(disk), list(mem)):
        assert len(got) == len(ref) == 8
        for (t, r), (tg, _, rg) in zip(ref, got):
            np.testing.assert_allclose(tg, t, rtol=0, atol=1e-9)
            np.testing.assert_array_equal(rg, r)
    assert ref[1][1][0, 6] == np.float32(eval_clone.NATIVE_FIRST_DT)
    assert np.isclose(ref[1][1][:, 6].sum(), 0.05)


@pytest.fixture(scope="module")
def cut_vocab():
    return (tbow.load_default_vocab(device="cpu")[:W_CUT].clone(),
            tbow.load_default_idf(device="cpu")[:W_CUT].clone())


def test_eval_vocab_histograms_match_jax(cut_vocab):
    """Three frames of the held-out world 207: the port's histogram path on
    the JAX feature tables equals JAX's extract + bow_histogram to 1e-6;
    on the port's own features (a few descriptor bits apart) the histograms
    stay close."""
    torch.set_num_threads(2)
    v, idf = cut_vocab
    seq = eval_vocab.render_lapped_sequence(207, 3)
    ref = np.stack([np.asarray(jbow.bow_histogram(
        f.desc_pm1, f.valid.astype(jnp.float32), jnp.asarray(v.numpy()),
        idf=jnp.asarray(idf.numpy()))) for f in (
            jex.extract(jnp.asarray(img, jnp.float32), n_features=N_FEAT, n_levels=8)
            for img, _, _ in seq)])
    with jax_features():
        got = eval_vocab.frame_histograms(seq, v, idf, N_FEAT, "cpu")
    np.testing.assert_allclose(got, ref, atol=1e-6)
    own = eval_vocab.frame_histograms(seq, v, idf, N_FEAT, "cpu")
    assert (np.sum(own * ref, axis=1) > 0.9).all()


def test_eval_vocab_main_matches_jax(tmp_path, monkeypatch, cut_vocab):
    """Both scripts' results on 8 frames a world with the cut vocabulary:
    the same worlds and revisits, recall@1 within one frame's share."""
    torch.set_num_threads(2)
    v, idf = cut_vocab
    monkeypatch.setattr(jbow, "load_default_vocab", lambda *a, **k: jnp.asarray(v.numpy()))
    monkeypatch.setattr(jbow, "load_default_idf", lambda *a, **k: jnp.asarray(idf.numpy()))
    monkeypatch.setattr(tbow, "load_default_vocab", lambda *a, **k: v)
    monkeypatch.setattr(tbow, "load_default_idf", lambda *a, **k: idf)
    args = ["--frames", "8", "--n-feat", str(N_FEAT)]
    monkeypatch.setattr(sys, "argv", ["eval_vocab.py", "--out", str(tmp_path / "j.json")] + args)
    _script("eval_vocab").main()
    ref = json.loads((tmp_path / "j.json").read_text())
    got = eval_vocab.main(["--device", "cpu", "--out", str(tmp_path / "t.json")] + args)
    assert json.loads((tmp_path / "t.json").read_text())["worlds"].keys() == ref["worlds"].keys()
    assert got["vocab_words"] == ref["vocab_words"] == W_CUT
    for name, r in ref["worlds"].items():
        g = got["worlds"][name]
        for k in ("seed", "tex_scale", "frames", "n_with_true_revisit"):
            assert g[k] == r[k], (name, k)
        assert abs(g["recall_at_1"] - r["recall_at_1"]) <= 1.0 / r["n_with_true_revisit"] + 1e-9
        assert g["threshold_sweep"].keys() == r["threshold_sweep"].keys()


def test_score_world_on_planted_revisits():
    """score_world on a hand-made sequence: lap 2 sees lap 1's places; the
    histograms make every frame's best match its true revisit except one."""
    F, laps = 8, 2
    C = np.tile(np.arange(4, dtype=float)[:, None] * np.array([[3.0, 0, 0]]), (2, 1))
    Rm = np.tile(np.eye(3), (F, 1, 1))
    H = np.zeros((F, 8))
    for i in range(F):
        H[i, i % 4] = 1.0
    H[7] = 0.0
    H[7, 5] = 1.0                  # frame 7 looks like nothing it saw
    w = eval_vocab.score_world(H, C, Rm, F, laps)
    assert w["n_with_true_revisit"] == 8
    assert w["recall_at_1"] == pytest.approx(6 / 8, abs=1e-3)   # frames 3 and 7 miss
    assert w["threshold_sweep"]["0.4"] == {"tp": 6, "fp": 0, "precision": 1.0, "recall": 0.75}
    assert w["threshold_sweep"]["0.05"]["tp"] == 6


README = """# title
<!-- ROBUSTNESS_TABLE -->
| profile | jax |
|---|---|
| euroc | 9.2 mm |
text after the JAX table
## The port
<!-- ROBUSTNESS_TABLE_TORCH -->
| old | table |
more text
"""


def test_make_readme_table(tmp_path):
    art = tmp_path / "artifacts"
    art.mkdir()
    (art / "ate_clone_hard_torch.json").write_text(json.dumps(dict(
        frames=1200, n_lost=540, n_relocs=2, tracking_finished_ok=True,
        ate_rmse_post_init=0.0471, loops_closed=0, e2e_fps_amortized=0.81,
        card="NVIDIA H100 80GB HBM3, 700.00 W")))
    # a result of the tool before the JAX keys: the port's own names
    (art / "ate_clone_euroc_torch.json").write_text(json.dumps(dict(
        frames=2400, lost_frames=0, lost=False, ate_post_rmse_m=0.00754, loops_closed=0,
        frame_ms_mean=1250.0, card="NVIDIA H100 80GB HBM3, 700.00 W")))
    (art / "ate_clone_hard.json").write_text("{}")         # a JAX artifact: not read
    readme = tmp_path / "README.md"
    readme.write_text(README)
    tab = make_readme_table.main(["--readme", str(readme), "--artifacts", str(art)])
    text = readme.read_text()
    assert text.split("## The port")[0] == README.split("## The port")[0]
    assert "| old | table |" not in text and text.endswith("more text\n")
    rows = tab.splitlines()
    assert len(rows) == 4 and rows[2].startswith("| euroc |") and rows[3].startswith("| hard |")
    assert "good (tracked throughout)" in rows[2] and "7.5 mm" in rows[2]
    assert "| 2400 |" in rows[2] and "0.80 (NVIDIA H100 80GB HBM3, 700.00 W)" in rows[2]
    assert "marginal (lost 45% of frames, relocalized x2)" in rows[3] and "47.1 mm" in rows[3]
    make_readme_table.main(["--readme", str(readme), "--artifacts", str(art)])
    assert readme.read_text() == text                          # idempotent
    readme.write_text("no marker\n")
    with pytest.raises(SystemExit):
        make_readme_table.main(["--readme", str(readme), "--artifacts", str(art)])
