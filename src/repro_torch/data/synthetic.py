"""Synthetic corpora and trained-like topic-word statistics.

* ``synthetic_lda_corpus`` — documents drawn from a ground-truth LDA model
  (Dirichlet topics over a Zipf-shaped vocabulary).  A numpy-only copy of
  ``repro.data.synthetic.synthetic_lda_corpus``: the same seed gives the
  same corpus in both packages.  Its dense (K, W) float64 topic draw makes
  it a small-model tool (11 GB at K = 10⁴, W = 141,043).
* ``trained_like_phi_blocks`` — (W, K) φ̂ sufficient statistics in row
  blocks, at any width: each word carries gamma mass on a few dozen topics,
  scaled by a Zipf envelope over the word ids, the shape a trained FOEM
  model's rows take.  Built block by block, so a full-width serving store
  never exists in host memory as one array.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.sparse.docword import DocWordMatrix

BLOCK_ROWS = 4096      # rows per block of trained_like_phi_blocks (160 MB at K = 10⁴)


def synthetic_lda_corpus(
    num_docs: int,
    vocab_size: int,
    num_topics: int,
    *,
    mean_doc_len: int = 64,
    alpha: float = 0.1,
    beta: float = 0.02,
    seed: int = 0,
    zipf_s: float = 1.05,
) -> Tuple[DocWordMatrix, np.ndarray]:
    """Draw a corpus from LDA's generative process.

    Topic-word distributions are Dirichlet(β) modulated by a Zipf envelope so
    word frequencies look like real text.  Returns (corpus, true_phi (W, K)).
    """
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab_size + 1) ** zipf_s
    phi = rng.dirichlet(np.full(vocab_size, beta) + 1e-6, size=num_topics)
    phi = phi * zipf[None, :]
    phi = phi / phi.sum(axis=1, keepdims=True)          # (K, W)

    indptr = [0]
    wids, cnts = [], []
    doc_lens = rng.poisson(mean_doc_len, size=num_docs).clip(min=4)
    for d in range(num_docs):
        theta = rng.dirichlet(np.full(num_topics, alpha))
        z_counts = rng.multinomial(doc_lens[d], theta)   # tokens per topic
        bag = np.zeros(vocab_size, np.int64)
        for k in np.nonzero(z_counts)[0]:
            bag += rng.multinomial(z_counts[k], phi[k])
        nz = np.nonzero(bag)[0]
        wids.append(nz.astype(np.int32))
        cnts.append(bag[nz].astype(np.float32))
        indptr.append(indptr[-1] + len(nz))
    corpus = DocWordMatrix(
        indptr=np.asarray(indptr, np.int64),
        word_ids=np.concatenate(wids),
        counts=np.concatenate(cnts),
        vocab_size=vocab_size,
    )
    return corpus, phi.T.copy()                          # vocab-major (W, K)


def trained_like_phi_blocks(
    vocab_size: int,
    num_topics: int,
    *,
    topics_per_word: int = 32,
    zipf_s: float = 1.05,
    tokens: float = 5e8,
    ranks: Optional[np.ndarray] = None,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Yield consecutive (≤ BLOCK_ROWS, K) float32 row blocks of φ̂.

    Word w gets Gamma(1, 1) mass on ``topics_per_word`` topics drawn
    uniformly, scaled so the rows sum to about ``tokens`` tokens under a
    Zipf(``zipf_s``) envelope over the words' frequency ``ranks`` (1-based;
    default w + 1 — pass ``TrafficGenerator.word_ranks()`` to match a
    request stream).  Deterministic in ``seed``.
    """
    rng = np.random.default_rng(seed)
    if ranks is None:
        ranks = np.arange(1, vocab_size + 1)
    zipf = np.asarray(ranks, np.float64) ** -float(zipf_s)  # lint: host-f64
    zipf *= float(tokens) / zipf.sum()
    a = min(int(topics_per_word), num_topics)
    for lo in range(0, vocab_size, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, vocab_size)
        n = hi - lo
        block = np.zeros((n, num_topics), np.float32)
        topics = rng.integers(0, num_topics, size=(n, a))
        mass = rng.gamma(1.0, 1.0, size=(n, a))
        mass *= (zipf[lo:hi] / mass.sum(1))[:, None]
        np.add.at(block, (np.arange(n)[:, None], topics),
                  mass.astype(np.float32))
        yield block
