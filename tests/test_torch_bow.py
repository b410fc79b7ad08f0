"""Parity of the port's bag-of-words place recognition with the JAX package
(mc_slam_tpu/frontend/bow.py, LoopDetector.detect of pipeline/loopclosing.py)
on the CPU. Word indices and decision lists are exact, histograms and scores
agree to 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.frontend import bow as jbow
from mc_slam_tpu.pipeline import loopclosing as jlc
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.frontend import bow as tbow
from mc_slam_tpu_torch.pipeline import loopclosing as tlc

W_CUT = 2048        # the shipped vocabulary cut to its first words


@pytest.fixture(scope="module")
def vocab():
    v = tbow.load_default_vocab(device="cpu")
    idf = tbow.load_default_idf(device="cpu")
    assert v.shape == (32768, 256) and v.dtype == torch.int8 and idf.shape == (32768,)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jbow.load_default_vocab()))
    np.testing.assert_array_equal(idf.numpy(), np.asarray(jbow.load_default_idf()))
    return v[:W_CUT].clone(), idf[:W_CUT].clone()


def _descs(rng, vocab, n=300, flips=40):
    """Descriptors near vocabulary words (a word with `flips` bits turned),
    so that the top-4 are structured and not noise."""
    words = vocab.numpy()[rng.integers(0, vocab.shape[0], n)].copy()
    for row in words:
        row[rng.choice(256, flips, replace=False)] *= -1
    valid = rng.random(n) > 0.1
    return words.astype(np.int8), valid


@pytest.mark.parametrize("soft_k", [1, 4])
@pytest.mark.parametrize("with_idf", [False, True])
def test_bow_histogram_matches_jax(rng, vocab, soft_k, with_idf):
    v, idf = vocab
    d, valid = _descs(rng, v)
    ref = jbow.bow_histogram(jnp.asarray(d), jnp.asarray(valid, jnp.float32),
                             jnp.asarray(v.numpy()), soft_k=soft_k,
                             idf=jnp.asarray(idf.numpy()) if with_idf else None)
    got = tbow.bow_histogram(torch.from_numpy(d), torch.from_numpy(valid), v, soft_k=soft_k,
                             idf=idf if with_idf else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert abs(float(torch.linalg.norm(got)) - 1.0) < 1e-5


@pytest.mark.parametrize("soft_k", [1, 4])
def test_word_assignment_breaks_planted_ties_as_jax(rng, vocab, soft_k):
    """Equal dots are the rule among integer dots: words 5, 700 and 1500 are
    made the same word and half of the descriptors ARE that word, others are
    all-(+1) rows against a vocabulary with repeated rows. The chosen word
    indices equal lax.top_k's (lowest index among equals), exactly."""
    v = vocab[0].clone()
    v[700] = v[5]
    v[1500] = v[5]
    v[1900:1910] = v[1234]
    d, _ = _descs(rng, v, n=64, flips=0)
    d[:32] = v[5].numpy()
    d[32:40] = v[1234].numpy()
    dot = jax.lax.dot_general(jnp.asarray(d), jnp.asarray(v.numpy()),
                              (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    ref_v, ref_i = jax.lax.top_k(dot, max(soft_k, 1))
    got_v, got_i = tbow.word_assignment(torch.from_numpy(d), v, soft_k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert set(got_i[:32, 0].tolist()) == {5}
    if soft_k == 4:
        assert got_i[0].tolist()[:3] == [5, 700, 1500]
    ref = jbow.bow_histogram(jnp.asarray(d), jnp.ones(64, jnp.float32),
                             jnp.asarray(v.numpy()), soft_k=soft_k)
    got = tbow.bow_histogram(torch.from_numpy(d), torch.ones(64), v, soft_k=soft_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_score_all_matches_jax(rng, vocab):
    v, idf = vocab
    hists = []
    for _ in range(6):
        d, valid = _descs(rng, v, n=200)
        hists.append(tbow.bow_histogram(torch.from_numpy(d), torch.from_numpy(valid), v,
                                        idf=idf))
    H = torch.stack(hists)
    mask = np.array([1, 1, 0, 1, 0, 1], bool)
    ref = jbow.score_all(jnp.asarray(H[0].numpy()), jnp.asarray(H.numpy()), jnp.asarray(mask))
    got = tbow.score_all(H[0], H, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert got[2] == -1.0 and abs(float(got[0]) - 1.0) < 1e-5


def test_train_vocab_majority_bits_match_jax(rng):
    """`train_vocab` from the same first words and the same re-seed rows: the
    JAX function's key splits are repeated here (`jax.random.choice` for the
    first words, one `random_vocab` per iteration), the port takes them as
    `init_vocab` and through `majority_step`. Every bit equal. 700 rows in
    pieces of 256 run the chunked loop three times, the last piece ragged."""
    n, n_words, iters = 700, 64, 3
    centres = (rng.random((24, 256)) < 0.5)
    d = centres[rng.integers(0, 24, n)] ^ (rng.random((n, 256)) < 0.08)
    d = (d.astype(np.int8) * 2 - 1)
    valid = (rng.random(n) > 0.05).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jbow.train_vocab(jnp.asarray(d), jnp.asarray(valid), key, n_words=n_words,
                           iters=iters, batch=256)
    key, sub = jax.random.split(key)
    init_idx = np.asarray(jax.random.choice(
        sub, n, (n_words,), replace=True,
        p=jnp.asarray(valid) / jnp.maximum(jnp.asarray(valid).sum(), 1.0)))
    vocab = torch.from_numpy(d[init_idx])
    td, tv = torch.from_numpy(d), torch.from_numpy(valid)
    for _ in range(iters):
        key, sub = jax.random.split(key)
        reseed = torch.from_numpy(np.array(jbow.random_vocab(sub, n_words)))
        vocab = tbow.majority_step(td, tv, vocab, reseed, batch=256)
    np.testing.assert_array_equal(vocab.numpy(), np.asarray(ref))
    # the public function, given the first words: same result while no word
    # is left without members (its re-seed rows come from its own generator)
    g = torch.Generator().manual_seed(0)
    own = tbow.train_vocab(td, tv, g, n_words=n_words, iters=1, batch=256,
                           init_vocab=torch.from_numpy(d[init_idx]))
    assert own.shape == (n_words, 256) and own.dtype == torch.int8
    assert set(np.unique(own.numpy())) <= {-1, 1}
    # drawn first words are valid descriptors
    drawn = tbow.train_vocab(td, tv, g, n_words=8, iters=0)
    rows = {r.tobytes() for r in d[valid > 0]}
    assert all(r.tobytes() in rows for r in drawn.numpy())


def test_compute_idf_matches_jax(rng, vocab):
    v = vocab[0][:512]
    d, valid = _descs(rng, v, n=600)
    doc = rng.integers(0, 7, 600).astype(np.int32)
    ref = jbow.compute_idf(jnp.asarray(d), jnp.asarray(valid, jnp.float32),
                           jnp.asarray(v.numpy()), jnp.asarray(doc), 7, batch=256)
    got = tbow.compute_idf(torch.from_numpy(d), torch.from_numpy(valid), v,
                           torch.from_numpy(doc), 7, batch=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_random_vocab_is_pm1(rng):
    g = torch.Generator().manual_seed(1)
    v = tbow.random_vocab(g, 128, device="cpu")
    assert v.shape == (128, 256) and v.dtype == torch.int8
    assert set(np.unique(v.numpy())) == {-1, 1} and abs(float(v.float().mean())) < 0.05


def _planted_events(rng, K=16):
    """Four consecutive detections on a 16-slot table: keyframe 3 and its
    covisible 4 score high against the current keyframes 12..15, slot 7
    scores high once (no streak), slot 9 scores under the covisible minimum."""
    W = np.zeros((K, K), np.float32)
    for a, b, w in [(3, 4, 40), (2, 3, 20), (7, 8, 30), (11, 12, 60), (12, 13, 70),
                    (13, 14, 80), (14, 15, 90), (11, 13, 20)]:
        W[a, b] = W[b, a] = w
    np.fill_diagonal(W, 300)
    events = []
    for e, slot in enumerate((12, 13, 14, 15)):
        s = rng.uniform(0.0, 0.1, K).astype(np.float32)
        s[slot] = 1.0
        s[[k for k in range(K) if W[slot, k] >= 15 and k != slot]] = 0.2 + 0.01 * e
        s[3], s[4] = 0.45 + 0.01 * e, 0.31
        s[9] = 0.17
        if e == 1:
            s[7] = 0.5
        events.append((slot, s, W))
    return events


def test_detect_decisions_match_jax_on_planted_streaks(rng):
    """`LoopDetector.detect` over four events on one handed-over state: the
    candidate lists (slot, streaked) and the consistency groups are equal,
    event by event; keyframe 3 gains its streak at the third event."""
    K = 16
    vocab = np.array(jbow.random_vocab(jax.random.PRNGKey(0), 64))
    jd = jlc.LoopDetector(jnp.asarray(vocab), K)
    kf_slots = list(range(K))
    kf_ids = {k: 12 * k for k in kf_slots}
    jd.hist_ids = dict(kf_ids)
    jd.consistent_groups = [(frozenset({3, 4}), 0)]
    td = convert.detector_from_dict(dict(
        hists=np.asarray(jd.hists), hist_ids=jd.hist_ids,
        consistent_groups=jd.consistent_groups, vocab=vocab, idf=None), device="cpu")
    assert convert.detector_to_dict(td)["consistent_groups"] == jd.consistent_groups
    seen = []
    for slot, s, W in _planted_events(rng, K):
        jd._dispatch_ids = dict(jd.hist_ids)
        td._dispatch_ids = dict(td.hist_ids)
        ref = jd.detect(None, slot, kf_slots, kf_ids=kf_ids,
                        handles=(jnp.asarray(s), jnp.asarray(W)))
        got = td.detect(None, slot, kf_slots, kf_ids=kf_ids,
                        handles=(torch.from_numpy(s), torch.from_numpy(W)))
        assert got == ref
        assert td.consistent_groups == jd.consistent_groups
        assert td.last_diag == jd.last_diag
        seen.append(got)
    assert (3, False) in seen[0] and (3, True) in seen[2] and seen[2][0] == (3, True)
    assert any(k == 7 for k, _ in seen[1]) and all(k != 9 for ev in seen for k, _ in ev)


def test_detect_drops_a_slot_recycled_since_the_dispatch(rng):
    """The stale-slot guard: a slot whose occupant changed between the
    dispatch's snapshot and the harvest is no candidate, on both sides."""
    K = 16
    vocab = np.array(jbow.random_vocab(jax.random.PRNGKey(0), 64))
    slot, s, W = _planted_events(rng, K)[0]
    kf_ids = {k: 12 * k for k in range(K)}
    jd = jlc.LoopDetector(jnp.asarray(vocab), K)
    td = tlc.LoopDetector(torch.from_numpy(vocab), K, device="cpu")
    for det in (jd, td):
        det.hist_ids = dict(kf_ids)
        det._dispatch_ids = dict(kf_ids)
        det.hist_ids[3] = 999           # slot 3 was recycled after the dispatch
    ref = jd.detect(None, slot, list(range(K)), kf_ids=kf_ids,
                    handles=(jnp.asarray(s), jnp.asarray(W)))
    got = td.detect(None, slot, list(range(K)), kf_ids=kf_ids,
                    handles=(torch.from_numpy(s), torch.from_numpy(W)))
    assert got == ref and all(k != 3 for k, _ in got)
