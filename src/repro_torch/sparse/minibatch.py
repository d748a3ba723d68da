"""Minibatch streaming over a (possibly unbounded) document source.

A numpy-only copy of ``repro.sparse.minibatch``: the same corpus, minibatch
size and seed give the same minibatches, in the same order, in both
packages.  The stream yields fixed-shape bucketed minibatches — the unit the
FOEM trainer consumes — with one bucket length per stream (``bucket_len``,
or one chosen from the corpus' 98% document-length quantile).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

from repro_torch.sparse.docword import (
    DocWordMatrix,
    bucket_length,
    bucketize,
    localize_vocab,
)


def prefetch_iterator(it: Iterable, depth: int = 2) -> Iterator:
    """Drain ``it`` on a background thread, staging up to ``depth`` items.

    Moves host-side minibatch construction (bucketize + localize_vocab)
    off the consumer's critical path; item order is preserved, so results
    are identical to iterating ``it`` directly.  Exceptions raised by the
    producer re-raise at the consumer's next pull.  Abandoning the
    generator (``close()`` / GC, e.g. a ``max_steps`` break upstream)
    stops the worker thread — even against an infinite source.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:   # re-raised on the consumer side
            put(e)

    thread = threading.Thread(target=worker, daemon=True,
                              name="minibatch-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5.0)


@dataclasses.dataclass
class Minibatch:
    """Host-side minibatch with both global and local (vocab-major) views."""

    word_ids: np.ndarray        # (D_s, L) global vocab ids
    counts: np.ndarray          # (D_s, L)
    local_vocab: np.ndarray     # (W_s,)  global ids of this minibatch's vocab
    local_word_ids: np.ndarray  # (D_s, L) ids into local_vocab
    index: int                  # minibatch counter s

    @property
    def num_docs(self) -> int:
        return self.word_ids.shape[0]

    @property
    def nnz(self) -> float:
        return float((self.counts > 0).sum())

    def ntokens(self) -> float:
        return float(self.counts.sum())


class MinibatchStream:
    """Cut a DocWordMatrix into minibatches of ``minibatch_docs`` documents.

    ``epochs=None`` yields forever (the paper's lifelong stream); the document
    order is reshuffled per epoch from a numpy generator seeded with ``seed``.
    """

    def __init__(
        self,
        corpus: DocWordMatrix,
        minibatch_docs: int,
        *,
        bucket_len: Optional[int] = None,
        seed: int = 0,
        epochs: Optional[int] = 1,
        drop_remainder: bool = True,
    ):
        self.corpus = corpus
        self.D_s = int(minibatch_docs)
        self.epochs = epochs
        self.drop_remainder = drop_remainder
        self.rng = np.random.default_rng(seed)
        if bucket_len is None:
            lens = np.diff(corpus.indptr)
            q = int(np.quantile(lens, 0.98)) if len(lens) else 1
            bucket_len = bucket_length(
                max(q, int(lens.max()) if len(lens) else 1))
        self.bucket_len = bucket_len

    def __iter__(self) -> Iterator[Minibatch]:
        s = 0
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            order = self.rng.permutation(self.corpus.num_docs)
            for lo in range(0, len(order), self.D_s):
                ids = order[lo: lo + self.D_s]
                if len(ids) < self.D_s:
                    if self.drop_remainder:
                        break
                    ids = np.concatenate([ids, order[: self.D_s - len(ids)]])
                word_ids, counts = bucketize(
                    self.corpus, ids, bucket_len=self.bucket_len
                )
                uniq, local = localize_vocab(word_ids)
                s += 1
                yield Minibatch(
                    word_ids=word_ids,
                    counts=counts,
                    local_vocab=uniq,
                    local_word_ids=local,
                    index=s,
                )
            epoch += 1

    def prefetch(self, depth: int = 2) -> Iterator[Minibatch]:
        """Iterate with background minibatch construction (see
        ``prefetch_iterator``); pairs with the store-level prefetch in
        ``core/streaming.StreamPrefetcher``, which also stages the φ̂ rows."""
        return prefetch_iterator(iter(self), depth=depth)

    def num_minibatches_per_epoch(self) -> int:
        return self.corpus.num_docs // self.D_s
