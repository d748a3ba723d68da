"""Sparse document-word matrices and the bucketed dense-ragged layout.

The paper stores x_{W×D} in compressed document-major or vocabulary-major
format (§2.3).  The kernels take fixed shapes, so a minibatch becomes a
*bucketed dense ragged* pair ``(word_ids, counts)`` of shape (D_s, L): each
document row holds its distinct-word entries left-justified, padded with
count 0.  L is the bucket capacity (max distinct words per doc in the
bucket, rounded up to a multiple of 8).

A numpy-only copy of ``repro.sparse.docword``: the port deploys without the
JAX package, so it keeps its own copy, byte-compatible in every output.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DocWordMatrix:
    """CSR-style sparse doc-word counts (document-major, like UCI bag-of-words)."""

    indptr: np.ndarray    # (D+1,) int64
    word_ids: np.ndarray  # (NNZ,) int32
    counts: np.ndarray    # (NNZ,) float32
    vocab_size: int

    @property
    def num_docs(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.word_ids)

    def ntokens(self) -> float:
        return float(self.counts.sum())

    def doc(self, d: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[d], self.indptr[d + 1]
        return self.word_ids[s:e], self.counts[s:e]

    def select(self, doc_ids: Sequence[int]) -> "DocWordMatrix":
        parts_w, parts_c, indptr = [], [], [0]
        for d in doc_ids:
            w, c = self.doc(int(d))
            parts_w.append(w)
            parts_c.append(c)
            indptr.append(indptr[-1] + len(w))
        return DocWordMatrix(
            indptr=np.asarray(indptr, np.int64),
            word_ids=(
                np.concatenate(parts_w) if parts_w else np.zeros(0, np.int32)
            ),
            counts=(
                np.concatenate(parts_c) if parts_c else np.zeros(0, np.float32)
            ),
            vocab_size=self.vocab_size,
        )

    def split_train_test(
        self, test_docs: int, rng: np.random.Generator
    ) -> Tuple["DocWordMatrix", "DocWordMatrix"]:
        perm = rng.permutation(self.num_docs)
        return self.select(perm[test_docs:]), self.select(perm[:test_docs])

    @classmethod
    def from_dense(cls, x: np.ndarray) -> "DocWordMatrix":
        """(D, W) dense counts -> CSR."""
        D, W = x.shape
        indptr = [0]
        wids: List[np.ndarray] = []
        cnts: List[np.ndarray] = []
        for d in range(D):
            nz = np.nonzero(x[d])[0]
            wids.append(nz.astype(np.int32))
            cnts.append(x[d, nz].astype(np.float32))
            indptr.append(indptr[-1] + len(nz))
        return cls(
            indptr=np.asarray(indptr, np.int64),
            word_ids=np.concatenate(wids) if wids else np.zeros(0, np.int32),
            counts=np.concatenate(cnts) if cnts else np.zeros(0, np.float32),
            vocab_size=W,
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.num_docs, self.vocab_size), np.float32)
        for d in range(self.num_docs):
            w, c = self.doc(d)
            out[d, w] += c
        return out


def bucket_length(max_terms: int, multiple: int = 8) -> int:
    """Round a ragged row length up to a lane-friendly multiple."""
    return max(multiple, ((max_terms + multiple - 1) // multiple) * multiple)


def bucketize(
    mat: DocWordMatrix,
    doc_ids: Sequence[int],
    bucket_len: Optional[int] = None,
    pad_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack selected docs into (D_s, L) ``word_ids, counts`` dense-ragged arrays.

    Documents longer than the bucket keep their ``bucket_len`` highest-count
    terms (tail truncation — logged by the stream; <0.1% tokens for the
    standard bucket policy on our corpora).
    """
    lens = [mat.indptr[d + 1] - mat.indptr[d] for d in doc_ids]
    L = bucket_len or bucket_length(int(max(lens)) if lens else 1, pad_multiple)
    D = len(doc_ids)
    word_ids = np.zeros((D, L), np.int32)
    counts = np.zeros((D, L), np.float32)
    for i, d in enumerate(doc_ids):
        w, c = mat.doc(int(d))
        if len(w) > L:
            top = np.argsort(-c)[:L]
            w, c = w[top], c[top]
        word_ids[i, : len(w)] = w
        counts[i, : len(c)] = c
    return word_ids, counts


def localize_vocab(
    word_ids: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Map a minibatch's global word ids onto a dense local vocabulary.

    Returns ``(unique_global_ids (W_s,), local_ids (same shape as word_ids))``
    — the vocab-major reorganisation of Fig. 4 / §3.2 that lets the parameter
    stream fetch exactly W_s rows.
    """
    uniq, local = np.unique(word_ids, return_inverse=True)
    return uniq.astype(np.int32), local.reshape(word_ids.shape).astype(np.int32)
