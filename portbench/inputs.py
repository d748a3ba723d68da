"""Inputs of a cell, made from ``--seed``: the trained-like φ̂ and the
documents.  Both sides of a run, the program and the reference, get them
from here; nothing here imports the program.

* :func:`phi_blocks` draws the (W, K) φ̂ on the device in row blocks: word
  w carries Exp(1) (= Gamma(1, 1)) mass on ``phi_topics_per_word`` topics,
  one from each of that many equal stripes of the K topics, scaled so
  that the rows follow a Zipf envelope over the words' traffic ranks and
  sum to ``phi_tokens``.  That is the shape of a trained FOEM model's rows.
  Every draw is a fixed sequence of calls on one ``torch.Generator``, and
  a row's topics are distinct, so the same seed gives the same bits.
* :class:`DocSource` draws documents: a token count uniform in
  ``doc_tokens``, each token a word drawn from Zipf(``zipf_exponent``)
  over a seeded permutation of the vocabulary, the tokens of one document
  merged into (word, count) pairs.  A document with more distinct words
  than ``bucket_len`` keeps its ``bucket_len`` highest-count words (ties:
  the lower word id), the policy of the port's ``bucketize``.  All in one
  vectorised pass a batch of documents.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A uint32 seed for stream ``tags`` of run ``seed``."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), *tags])
               .generate_state(1)[0])


# stream tags of a run's seed
PHI, DOCS, RANKS, TRAINER, ROUTER, SAMPLE = range(6)


def word_of_rank(cfg: dict, seed: int) -> np.ndarray:
    """(W,) the word id at each Zipf rank (rank 1 first)."""
    rng = np.random.default_rng(sub_seed(seed, RANKS))
    return rng.permutation(cfg["vocab_size"])


def phi_blocks(cfg: dict, seed: int, device, block_rows: int = 8192
               ) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield ``(first_row, (n, K) float32 block)`` of the trained-like φ̂,
    on ``device``."""
    W, K = cfg["vocab_size"], cfg["num_topics"]
    T = min(int(cfg["phi_topics_per_word"]), K)
    stripe = K // T
    ranks = np.empty(W, np.int64)
    ranks[word_of_rank(cfg, seed)] = np.arange(1, W + 1)
    zipf = torch.from_numpy(ranks).to(device=device,
                                      dtype=torch.float64) ** -float(
        cfg["zipf_exponent"])
    zipf *= float(cfg["phi_tokens"]) / zipf.sum()
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, PHI))
    lanes = torch.arange(T, device=device) * stripe
    for lo in range(0, W, block_rows):
        n = min(block_rows, W - lo)
        topics = torch.randint(0, stripe, (n, T), generator=gen,
                               device=device) + lanes
        mass = torch.empty((n, T), dtype=torch.float64, device=device)
        mass.exponential_(1.0, generator=gen)
        mass *= (zipf[lo:lo + n] / mass.sum(1))[:, None]
        block = torch.zeros((n, K), dtype=torch.float32, device=device)
        block.scatter_(1, topics, mass.to(torch.float32))
        yield lo, block


class Docs(NamedTuple):
    """A batch of documents in CSR form, rows sorted by word id."""
    indptr: np.ndarray      # (n + 1,) int64
    words: np.ndarray       # (nnz,) int32
    counts: np.ndarray      # (nnz,) float32
    tokens_drawn: int       # tokens before the cut to bucket_len
    tokens_cut: int         # tokens the cut removed

    @property
    def num_docs(self) -> int:
        return len(self.indptr) - 1

    def doc(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.words[s:e], self.counts[s:e]


class DocSource:
    """Seeded documents of one configuration (see the module docstring)."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.seed = int(seed)
        self.W = int(cfg["vocab_size"])
        self.L = int(cfg["bucket_len"])
        self.word_of_rank = word_of_rank(cfg, seed)
        p = np.arange(1, self.W + 1, dtype=np.float64) ** -float(
            cfg["zipf_exponent"])
        self.cdf = np.cumsum(p / p.sum())

    def docs(self, tag: int, n: int) -> Docs:
        """Batch ``tag`` of ``n`` documents: the same (seed, tag, n) give
        the same documents."""
        rng = np.random.default_rng(sub_seed(self.seed, DOCS, tag))
        lo, hi = self.cfg["doc_tokens"]
        lens = rng.integers(lo, hi + 1, size=n)
        u = rng.random(int(lens.sum()))
        rank = np.minimum(np.searchsorted(self.cdf, u, side="right"),
                          self.W - 1)
        doc = np.repeat(np.arange(n, dtype=np.int64), lens)
        key, cnt = np.unique(doc * self.W + self.word_of_rank[rank],
                             return_counts=True)
        d, w = key // self.W, key % self.W
        # the cut: a document keeps its L highest-count words
        order = np.lexsort((w, -cnt, d))
        start = np.searchsorted(d[order], np.arange(n))
        pos = np.arange(len(order)) - np.repeat(start, np.bincount(
            d[order], minlength=n))
        keep = np.sort(order[pos < self.L])
        cut = int(cnt.sum() - cnt[keep].sum())
        d, w, cnt = d[keep], w[keep], cnt[keep]
        indptr = np.concatenate([[0], np.cumsum(np.bincount(d, minlength=n))])
        return Docs(indptr.astype(np.int64), w.astype(np.int32),
                    cnt.astype(np.float32), int(lens.sum()), cut)


def dense_layout(docs: Docs, L: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, L) ``word_ids, counts``: each document's words left-justified,
    padded with word 0 and count 0."""
    n = docs.num_docs
    lens = np.diff(docs.indptr)
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(len(docs.words)) - np.repeat(docs.indptr[:-1], lens)
    word_ids = np.zeros((n, L), np.int32)
    counts = np.zeros((n, L), np.float32)
    word_ids[rows, cols] = docs.words
    counts[rows, cols] = docs.counts
    return word_ids, counts


def localize(word_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(vocab (W_s,), local ids)``: the minibatch's distinct words (the
    padding's word 0 among them) and each slot's index into them."""
    vocab, local = np.unique(word_ids, return_inverse=True)
    return vocab.astype(np.int32), local.reshape(word_ids.shape).astype(
        np.int32)


def doc_list(docs: Docs) -> List[Tuple[np.ndarray, np.ndarray]]:
    return [docs.doc(i) for i in range(docs.num_docs)]
