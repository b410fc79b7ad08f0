"""Place-recognition evaluation of the shipped vocabulary off its training
distribution (the counterpart of examples/eval_vocab.py for
`mc_slam_tpu_torch`).

    python3 -m mc_slam_tpu_torch.tools.eval_vocab [--frames 160] [--laps 2]
        [--n-feat 1024] [--out artifacts/vocab_eval_torch.json] [--device cpu]

Four worlds, as in the JAX script: the training distribution (render seed
100; the vocabulary was trained on seeds 100-102), two held-out worlds
(seeds 207 and 213) and a self-aliased one (seed 213 with a periodic wall
texture, tex_scale 0.22). Each renders a 2-lap closed trajectory on the
host (`sim`), so every frame of lap 2 has a true revisit in lap 1; every
frame goes through `extractor.extract` (8 levels) and `bow.bow_histogram`
with the shipped vocabulary and idf (read in place from the JAX package's
assets) on the device. Ground truth comes from the camera poses: the same
place is within 1.2 m and 35 degrees of viewing direction, and candidates
closer in time than frames / (2 laps) are excluded. Reports recall@1, the
median top score of frames with and without a true revisit, and precision
and recall at detection thresholds 0.05-0.40; writes them with the card's
name and power limit. Needs a GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# (name, render seed, tex_scale) of the JAX script's worlds
WORLDS = (("train_dist", 100, 1.0), ("heldout", 207, 1.0), ("heldout2", 213, 1.0),
          ("aliased", 213, 0.22))
THRESHOLDS = (0.05, 0.10, 0.15, 0.20, 0.25, 0.30, 0.40)


def render_lapped_sequence(seed, frames, laps=2, tex_scale=1.0, duration=64.0):
    """[(img, P, R)] of `frames` views along a `laps`-lap closed trajectory of
    the room world of `seed` (R, P: world-from-camera)."""
    from mc_slam_tpu_torch.camera import euroc_camera
    from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld
    cam = euroc_camera(device="cpu")
    world = RoomWorld(np.random.default_rng(seed), tex_size=1024, tex_scale=tex_scale)
    traj = MavTrajectory(duration=duration / laps, seed_phase=seed * 0.31)
    out = []
    for i in range(frames):
        P, R = traj.pose(i * duration / frames)
        out.append((world.render(cam, R, P), P, R))
    return out


def frame_histograms(seq, vocab, idf, n_feat, device):
    """(F, W) BoW histograms of the frames, each from its own extraction."""
    from mc_slam_tpu_torch.frontend import bow, extractor
    hists = []
    for img, _, _ in seq:
        f = extractor.extract(torch.as_tensor(np.asarray(img, np.float32), device=device),
                              n_features=n_feat, n_levels=8)
        hists.append(bow.bow_histogram(f.desc_pm1, f.valid.to(torch.float32), vocab, idf=idf))
    return torch.stack(hists).cpu().numpy()


def score_world(H, C, Rm, frames, laps):
    """Retrieval against pose ground truth (examples/eval_vocab.py:104-143):
    H (F, W) histograms, C (F, 3) camera centres, Rm (F, 3, 3) camera
    rotations. Returns the world's result dict (without seed / tex_scale)."""
    S = H @ H.T
    F = len(H)
    d = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
    fwd = Rm[:, :, 2]
    cosang = np.clip(np.einsum("id,jd->ij", fwd, fwd), -1, 1)
    same_place = (d < 1.2) & (cosang > np.cos(np.deg2rad(35.0)))
    gap = frames // (2 * laps)
    far = np.abs(np.arange(F)[:, None] - np.arange(F)[None, :]) >= gap
    Sm = np.where(far, S, -np.inf)
    top = np.argmax(Sm, axis=1)
    top_score = Sm[np.arange(F), top]
    has_true = (same_place & far).any(axis=1)
    hit = same_place[np.arange(F), top] & far[np.arange(F), top]
    recall1 = float(hit[has_true].mean()) if has_true.any() else -1.0
    sweep = {}
    for th in THRESHOLDS:
        fired = top_score >= th
        tp = int((fired & hit).sum())
        fp = int((fired & ~same_place[np.arange(F), top]).sum())
        rec = float((fired & hit)[has_true].mean()) if has_true.any() else -1
        sweep[str(th)] = {"tp": tp, "fp": fp, "precision": round(tp / max(tp + fp, 1), 3),
                          "recall": round(rec, 3)}
    return {"frames": F, "n_with_true_revisit": int(has_true.sum()),
            "recall_at_1": round(recall1, 3),
            "median_top_score_true": round(float(np.median(top_score[has_true]))
                                           if has_true.any() else -1, 3),
            "median_top_score_false": round(float(np.median(top_score[~has_true]))
                                            if (~has_true).any() else -1, 3),
            "threshold_sweep": sweep}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--laps", type=int, default=2)
    ap.add_argument("--n-feat", type=int, default=1024)
    ap.add_argument("--out", default="artifacts/vocab_eval_torch.json")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from mc_slam_tpu_torch.device import resolve
    from mc_slam_tpu_torch.frontend import bow
    from mc_slam_tpu_torch.tools import probes
    dev = resolve(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("eval_vocab: no GPU (pass --device cpu to run on the host)")
        card = probes.card_line()
    print(card, flush=True)
    vocab = bow.load_default_vocab(device=dev)
    idf = bow.load_default_idf(device=dev)
    print(f"# vocab: {vocab.shape[0]} words, idf {'loaded' if idf is not None else 'absent'}",
          file=sys.stderr)
    results = {"worlds": {}, "vocab_words": int(vocab.shape[0]), "train_seeds": [100, 101, 102],
               "card": card, "torch": torch.__version__, "n_feat": args.n_feat}
    for name, seed, tex_scale in WORLDS:
        t0 = time.perf_counter()
        seq = render_lapped_sequence(seed, args.frames, laps=args.laps, tex_scale=tex_scale)
        t1 = time.perf_counter()
        H = frame_histograms(seq, vocab, idf, args.n_feat, dev)
        t2 = time.perf_counter()
        w = score_world(H, np.stack([p for _, p, _ in seq]), np.stack([r for _, _, r in seq]),
                        args.frames, args.laps)
        results["worlds"][name] = {"seed": seed, "tex_scale": tex_scale, **w,
                                   "render_s": t1 - t0, "extract_bow_ms_per_frame":
                                   (t2 - t1) * 1e3 / max(len(seq), 1)}
        print(f"# {name}: recall@1={w['recall_at_1']:.3f} "
              f"true-med={w['median_top_score_true']} false-med={w['median_top_score_false']}",
              file=sys.stderr)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: v["recall_at_1"] for k, v in results["worlds"].items()}), flush=True)
    return results


if __name__ == "__main__":
    main()
