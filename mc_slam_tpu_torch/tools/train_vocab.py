"""Train a BoW vocabulary with the port (the counterpart of
examples/train_vocab.py).

The reference ships a ~1M-node DBoW2 tree trained offline (ORBvoc,
TemplatedVocabulary.h:1467). The flat vocabulary of `frontend.bow` needs far
fewer words, because assignment is an exact argmax over ALL words rather than
a greedy tree descent. This script harvests ORB descriptors from the frames
of an ASL folder, or else from rendered viewpoints of three synthetic rooms,
k-majority-trains the words (`bow.train_vocab`), weighs them by idf over the
harvested frames (`bow.compute_idf`) and writes the shipped asset's format
(packed bits, n_words, idf), which `bow.load_vocab` reads.

    python3 -m mc_slam_tpu_torch.tools.train_vocab [--mav0 DIR] [--words 4096]
        [--out vocab.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mav0", default="", help="optional ASL folder to harvest from")
    ap.add_argument("--words", type=int, default=32768)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--n-feat", type=int, default=1024)
    ap.add_argument("--out", default="vocab.npz")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from mc_slam_tpu_torch.device import resolve
    from mc_slam_tpu_torch.frontend import bow, extractor
    dev = resolve(args.device)

    def harvest(img):
        f = extractor.extract(torch.as_tensor(np.asarray(img, np.float32), device=dev),
                              n_features=args.n_feat, n_levels=8)
        return f.desc_pm1[f.valid]

    descs = []
    if args.mav0:
        from mc_slam_tpu_torch.io import euroc
        seq = euroc.load_sequence(args.mav0)
        paths = list(seq.image_paths)[::max(1, len(seq.image_paths) // args.frames)]
        for p in paths[:args.frames]:
            descs.append(harvest(euroc.load_gray_image(p)))
            print(f"harvested {len(descs[-1])} descriptors from {os.path.basename(p)}",
                  file=sys.stderr)
    else:
        # no dataset: freshly rendered room worlds (three seeds)
        from mc_slam_tpu_torch.camera import euroc_camera
        from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld
        cam = euroc_camera(device="cpu")
        per = max(args.frames // 3, 1)
        for seed in range(3):
            world = RoomWorld(np.random.default_rng(100 + seed), tex_size=1024)
            traj = MavTrajectory(duration=60.0, seed_phase=seed * 1.7)
            for i in range(per):
                P, R = traj.pose(i * 60.0 / per)
                descs.append(harvest(world.render(cam, R, P)))

    alld = torch.cat(descs)
    print(f"training on {len(alld)} descriptors -> {args.words} words", file=sys.stderr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ones = torch.ones(len(alld), device=dev)
    vocab = bow.train_vocab(alld, ones, gen, n_words=args.words, iters=args.iters)
    # idf over the corpus, one document per harvested frame (DBoW2's tf-idf
    # word weights, ScoringObject.cpp / setNodeWeights)
    doc_id = torch.cat([torch.full((len(d),), i, dtype=torch.int64, device=dev)
                        for i, d in enumerate(descs)])
    idf = bow.compute_idf(alld, ones, vocab, doc_id, len(descs))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    bits = np.packbits((vocab.cpu().numpy() > 0).astype(np.uint8), axis=1)
    np.savez_compressed(args.out, bits=bits, n_words=args.words,
                        idf=idf.cpu().numpy().astype(np.float32))
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KiB)")
    return args.out


if __name__ == "__main__":
    main()
