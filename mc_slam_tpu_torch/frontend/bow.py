"""Place recognition: binary bag-of-words as dense products (port of
mc_slam_tpu/frontend/bow.py, the role of DBoW2).

A FLAT vocabulary of W binary centroids; descriptor -> word assignment is one
(N, 256) @ (256, W) product of +/-1 rows and a top-k; a keyframe is one
tf-idf-weighted, L2-normalized histogram over the words; retrieval is one
(K, W) @ (W,) product against every keyframe's histogram.

The +/-1 product runs in float32 (TF32 is off package-wide): every partial sum
is an integer of magnitude <= 256, so the float result is exact and equal to
the JAX package's int32 `dot_general`. `top_k` ties (the rule among 32768
words and integer dots in [-256, 256]) go to the LOWEST word index, as
`jax.lax.top_k` breaks them: one integer key `dot * W + (W - 1 - col)` is
sorted instead of the dots (`_topk_lowest`), because `torch.topk` promises no
order among equal values.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mc_slam_tpu_torch.device import resolve

DEFAULT_WORDS = 2048

# the vocabulary is data, read in place from the reference package's assets
_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "mc_slam_tpu", "assets", "vocab.npz")


def load_vocab(path, device=None):
    """(vocab (W, 256) int8 +/-1, idf (W,) float32 or None) from a vocabulary
    file: packed bits, n_words, optional idf (the shipped asset's format, which
    tools/train_vocab.py writes)."""
    dev = resolve(device)
    with np.load(path) as z:
        bits = np.unpackbits(z["bits"], axis=1)[:, :256]
        idf = torch.from_numpy(z["idf"].astype(np.float32)).to(dev) if "idf" in z else None
    return torch.from_numpy(bits.astype(np.int8) * 2 - 1).to(dev), idf


def load_default_vocab(generator: torch.Generator | None = None, device=None):
    """The shipped trained vocabulary ((W, 256) int8 +/-1; the ORBvoc
    artifact's role); a random vocabulary when the asset is absent."""
    dev = resolve(device)
    if os.path.exists(_ASSET):
        return load_vocab(_ASSET, dev)[0]
    return random_vocab(generator, device=dev)


def load_default_idf(device=None):
    """(W,) float32 inverse-document-frequency weights shipped with the
    vocabulary; None when the asset has none."""
    dev = resolve(device)
    if os.path.exists(_ASSET):
        return load_vocab(_ASSET, dev)[1]
    return None


def random_vocab(generator: torch.Generator | None = None, n_words=DEFAULT_WORDS,
                 device=None):
    """(W, 256) int8 +/-1 random binary centroids."""
    dev = resolve(device if device is not None
                  else (generator.device if generator is not None else None))
    bits = torch.rand((n_words, 256), generator=generator, device=dev) < 0.5
    return bits.to(torch.int8) * 2 - 1


def _dots(desc_pm1, vocab):
    """(N, W) int32 dots of +/-1 rows, exact (see the module docstring)."""
    return (desc_pm1.to(torch.float32) @ vocab.to(torch.float32).T).to(torch.int32)


def _topk_lowest(dot, k):
    """top-k over the last axis of an int32 (N, W) matrix with |dot| <= 256,
    equal values to the lowest column. Returns (values int32, columns int64)."""
    W = dot.shape[-1]
    col = torch.arange(W, dtype=torch.int32, device=dot.device)
    key = dot * W + (W - 1 - col)               # 257 * W fits int32 for W <= 2**22
    topkey = torch.topk(key, k, dim=-1, sorted=True).values
    topv = torch.div(topkey, W, rounding_mode="floor")
    topi = W - 1 - (topkey - topv * W)
    return topv, topi.to(torch.int64)


def _argmax_lowest(dot):
    return _topk_lowest(dot, 1)[1][..., 0]


def word_assignment(desc_pm1, vocab, soft_k: int = 4):
    """(values (N, k) int32, word indices (N, k) int64) of each descriptor's
    `soft_k` closest words, ties to the lowest word."""
    return _topk_lowest(_dots(desc_pm1, vocab), max(soft_k, 1))


def bow_histogram(desc_pm1, valid, vocab, soft_k: int = 4, idf=None):
    """tf histogram over the vocabulary words, L2-normalized:
    (N, 256), (N,), (W, 256) -> (W,) float32. With soft_k > 1 each descriptor
    votes for its top-k words, weighted exp(0.02 * (dot - best dot)); `idf`
    (W,) scales the histogram before the normalization."""
    W = vocab.shape[0]
    validf = valid.to(torch.float32)
    topv, topi = word_assignment(desc_pm1, vocab, soft_k)
    hist = torch.zeros(W, dtype=torch.float32, device=vocab.device)
    if soft_k <= 1:
        hist.index_add_(0, topi[:, 0], validf)
    else:
        w = torch.exp(0.02 * (topv - topv[:, :1]).to(torch.float32))
        hist.index_add_(0, topi.reshape(-1), (w * validf[:, None]).reshape(-1))
    if idf is not None:
        hist = hist * torch.clamp(idf, min=0.0)
    return hist / torch.clamp(torch.linalg.norm(hist), min=1e-9)


def score_all(query_hist, kf_hists, kf_mask):
    """Similarity of a query histogram against every keyframe's:
    (W,), (K, W), (K,) -> (K,), -1 where the mask is off."""
    s = kf_hists @ query_hist
    return torch.where(kf_mask, s, -1.0)


def _chunks(desc_pm1, valid, batch, *more):
    N = desc_pm1.shape[0]
    for a in range(0, N, batch):
        yield (desc_pm1[a:a + batch], valid[a:a + batch].to(torch.float32)) \
            + tuple(x[a:a + batch] for x in more)


def compute_idf(desc_pm1, valid, vocab, doc_id, n_docs, soft_k: int = 4,
                batch: int = 4096):
    """idf from a training corpus: log(N / (1 + df_w)), df_w the number of
    documents (frames) with a valid descriptor voting for word w under the
    soft top-k assignment of `bow_histogram`. doc_id: (N,) frame index per
    descriptor. In `batch`-row pieces: the dense (N, W) matrix of a whole
    corpus would not fit."""
    W = vocab.shape[0]
    seen = torch.zeros(n_docs * W, dtype=torch.float32, device=vocab.device)
    for d_c, v_c, doc_c in _chunks(desc_pm1, valid, batch, doc_id.to(torch.int64)):
        _, topi = word_assignment(d_c, vocab, soft_k)
        flat = (doc_c[:, None] * W + topi).reshape(-1)
        seen.index_add_(0, flat, v_c[:, None].expand_as(topi).reshape(-1))
    df = (seen.reshape(n_docs, W) > 0).to(torch.float32).sum(dim=0)
    return torch.log(float(n_docs) / (1.0 + df))


def train_vocab(desc_pm1, valid, generator: torch.Generator | None = None,
                n_words=DEFAULT_WORDS, iters=4, batch=4096, init_vocab=None):
    """k-majority clustering of +/-1 descriptors (binary k-means).
    desc_pm1: (N, 256) int8; valid: (N,). The first words are `init_vocab`
    when given, else n_words valid descriptors drawn with replacement; a word
    that no descriptor chose is drawn again at random. The assignment runs in
    `batch`-row pieces."""
    dev = desc_pm1.device
    validf = valid.to(torch.float32)
    if init_vocab is None:
        p = validf / torch.clamp(validf.sum(), min=1.0)
        init_idx = torch.multinomial(p, n_words, replacement=True, generator=generator)
        vocab = desc_pm1[init_idx]
    else:
        vocab = init_vocab
    for _ in range(iters):
        vocab = majority_step(desc_pm1, validf, vocab,
                              random_vocab(generator, n_words, device=dev), batch)
    return vocab


def majority_step(desc_pm1, valid, vocab, reseed, batch=4096):
    """One k-majority iteration: every valid descriptor goes to its closest
    word (ties to the lowest), each word becomes the bitwise majority of its
    members (a tie of bits gives +1); words without members take their row of
    `reseed`."""
    n_words = vocab.shape[0]
    sums = torch.zeros((n_words, 256), dtype=torch.float32, device=vocab.device)
    counts = torch.zeros(n_words, dtype=torch.float32, device=vocab.device)
    for d_c, v_c in _chunks(desc_pm1, valid, batch):
        assign = _argmax_lowest(_dots(d_c, vocab))
        sums.index_add_(0, assign, d_c.to(torch.float32) * v_c[:, None])
        counts.index_add_(0, assign, v_c)
    maj = torch.where(sums >= 0, 1, -1).to(torch.int8)
    return torch.where((counts > 0)[:, None], maj, reseed.to(torch.int8))
