"""Serving driver — topic inference for unseen documents, the paper's
deployment mode (PyTorch port of ``repro.launch.serve``).

LDA serving = the E-step with FROZEN φ̂ (§2.4): per request batch, fit θ̂
only — the θ-only fixed point of eq. 11 with the φ M-step switched off —
and return the per-document topic mixture (eq. 9).  Requests stream
against the disk-backed parameter store (``ParameterStore``, optionally
behind a ``HotRowCache``); the fit routes through ``kernels.ops.infer``,
whose chunks run the hand-written Hopper kernel on the card.

    serve_lda (CLI) ─► TopicServer.infer_stream / infer / evaluate
                          │  localize_vocab → fetch φ̂ rows (HotRowCache →
                          │  ParameterStore) → pad W_s to vocab_pad
                          ▼
                       _infer_local: eq. 10 with the global W → ops.infer
                          │  check_every-sweep chunks, rel_tol stop
                          ▼
                       theta_sweep kernel (csrc/theta_sweep.cu)

The continuous-batching engine, the admission router, lifelong hot-swap
and replicas come with later slices.

Run the CLI on a GPU host with
``PYTHONPATH=src python -m repro_torch.launch.serve --workdir DIR --topics K
--vocab W [--make-store]``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import em
from repro_torch.core.perplexity import init_theta, serving_active_topics
from repro_torch.core.streaming import (
    HotRowCache,
    ParameterStore,
    store_from_arrays,
)
from repro_torch.core.types import InferPlan, LDAConfig, MinibatchData
from repro_torch.data.synthetic import trained_like_phi_blocks
from repro_torch.kernels import ops as kops
from repro_torch.runtime.device import Device, resolve_device
from repro_torch.sparse.docword import DocWordMatrix, bucketize, localize_vocab


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class ThetaResult(np.ndarray):
    """A (K,) θ mixture stamped with the φ version that produced it (−1
    when serving straight from the store).  Behaves exactly like the plain
    ndarray; the version tag rides along as an attribute."""

    version: int = -1

    @staticmethod
    def wrap(theta: np.ndarray, version: int) -> "ThetaResult":
        out = np.asarray(theta).view(ThetaResult)
        out.version = int(version)
        return out


def _infer_local(word_ids, counts, ev_counts, rows, phi_k, cfg: LDAConfig,
                 *, fit_sweeps: int, check_every: int, rel_tol: float,
                 active_topics: int, phi_dtype: str = "float32",
                 seed: int = 0, theta0=None,
                 device: torch.device) -> Tuple[torch.Tensor, int,
                                                torch.Tensor]:
    """One request batch: normalise the streamed (W_s, K) view (eq. 10 with
    the *global* W smoothing mass), fit θ̂ through ``ops.infer`` and return
    the eq. 9 mixtures, the sweeps run and the eq. 21 numerator.

    θ̂₀ is ``theta0`` when given, else drawn from a generator seeded with
    ``seed`` on ``device``.  ``phi_k`` arrives as the host float64 totals
    and is cast to float32 here, at the launch.
    """
    word_ids = torch.as_tensor(word_ids, dtype=torch.int32).to(device)
    counts = torch.as_tensor(counts, dtype=torch.float32).to(device)
    if theta0 is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        theta0 = init_theta(gen, MinibatchData(word_ids, counts), cfg)
    rows = torch.as_tensor(rows, dtype=torch.float32).to(device)
    phi_k = torch.as_tensor(phi_k).to(device=device, dtype=torch.float32)
    phi_norm = em.normalize_phi(rows, phi_k, cfg, vocab_size=cfg.W)
    res = kops.infer(
        word_ids, counts, theta0, phi_norm,
        alpha_m1=cfg.alpha_m1, ev_counts=ev_counts,
        word_topics=(
            serving_active_topics(phi_norm, active_topics)
            if active_topics else None
        ),
        max_sweeps=fit_sweeps, check_every=check_every, rel_tol=rel_tol,
        plan=InferPlan(phi_dtype=phi_dtype), debug_checks=cfg.debug_checks,
        device=device,
    )
    return em.normalize_theta(res.theta, cfg), res.sweeps, res.ev_loglik


class TopicServer:
    """Batched topic-mixture inference against a (possibly disk-backed) φ̂.

    The paper's deployment mode (§2.4): per request batch, stream exactly
    the W_s touched φ̂ rows from the store, fit θ̂ with φ̂ frozen through
    ``ops.infer`` (convergence-stopped), and return the eq. 9 topic
    mixtures.  Identical requests give identical θ: the init generator is
    seeded per call (``seed=``, default 0) and never advanced by the server.

    Knobs: ``fit_sweeps`` caps the fixed point, ``rel_tol``/``check_every``
    are the §2.4 relative stop rule (defaults from the config),
    ``active_topics > 0`` restricts each word's fit support to its top-A
    topics by φ mass, ``phi_dtype`` stores the frozen φ block in bf16/int8
    (dequantized on read inside the kernel), ``hot_rows > 0`` layers a
    read-only hot-word row LRU (:class:`HotRowCache`) over the store, and
    ``vocab_pad`` rounds W_s up so batches share shapes.  ``device``
    defaults to ``"cuda"`` and raises without a GPU; ``device="cpu"`` runs
    the plain PyTorch path.
    """

    def __init__(self, store: ParameterStore, cfg: LDAConfig,
                 fit_sweeps: int = 50, *,
                 rel_tol: Optional[float] = None,
                 check_every: Optional[int] = None,
                 active_topics: int = 0,
                 vocab_pad: int = 512,
                 phi_dtype: str = "float32",
                 hot_rows: int = 0,
                 device: Device = "cuda"):
        kops.refuse_debug_checks(cfg.debug_checks, "TopicServer")
        self.device = resolve_device(device)
        self.store = store
        self.cfg = cfg
        self.fit_sweeps = fit_sweeps
        self.rel_tol = cfg.ppl_rel_tol if rel_tol is None else rel_tol
        self.check_every = (
            cfg.ppl_check_every if check_every is None else check_every
        )
        self.active_topics = active_topics
        self.vocab_pad = max(1, vocab_pad)
        self.phi_dtype = phi_dtype
        self.hot_cache = (
            HotRowCache(store, hot_rows) if hot_rows > 0 else None
        )
        self.last_sweeps = 0                 # fixed-point sweeps of last call
        # host seconds of the last call: row fetch (store/cache + W_s
        # padding) and fit (host→device copy, eq. 10, ops.infer, θ back)
        self.last_seconds = {"fetch": 0.0, "fit": 0.0}

    def _fetch_rows(self, uniq: np.ndarray) -> np.ndarray:
        if self.hot_cache is not None:
            return self.hot_cache.fetch(uniq)
        return self.store.fetch_rows(uniq)

    def _run(self, word_ids: np.ndarray, counts: np.ndarray,
             ev_counts: Optional[np.ndarray], seed: int, theta0):
        t0 = time.perf_counter()
        uniq, local = localize_vocab(np.asarray(word_ids))
        rows = self._fetch_rows(uniq)                      # streamed φ̂
        # pad the local vocab to a bucket boundary so batches share shapes
        # (padded rows are never indexed by `local`)
        pad = _round_up(len(uniq), self.vocab_pad) - len(uniq)
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((pad, rows.shape[1]), rows.dtype)]
            )
        t1 = time.perf_counter()
        theta, sweeps, ev_ll = _infer_local(
            local, counts, ev_counts, rows, self.store.phi_k, self.cfg,
            fit_sweeps=self.fit_sweeps, check_every=self.check_every,
            rel_tol=self.rel_tol, active_topics=self.active_topics,
            phi_dtype=self.phi_dtype, seed=seed, theta0=theta0,
            device=self.device,
        )
        theta = theta.cpu().numpy()          # waits for the device
        self.last_sweeps = int(sweeps)
        self.last_seconds = {"fetch": t1 - t0,
                             "fit": time.perf_counter() - t1}
        return theta, ev_ll

    def infer(self, word_ids: np.ndarray, counts: np.ndarray, *,
              seed: int = 0, theta0=None) -> np.ndarray:
        """(B, L) docs -> (B, K) normalized topic mixtures θ (eq. 9)."""
        theta, _ = self._run(word_ids, counts, None, seed, theta0)
        return theta

    def evaluate(self, word_ids: np.ndarray, est_counts: np.ndarray,
                 ev_counts: np.ndarray, *, seed: int = 0, theta0=None
                 ) -> Tuple[np.ndarray, float]:
        """Held-out evaluation: fit θ̂ on ``est_counts``, score ``ev_counts``
        with eq. 21 in the same launches.  Returns ``(theta (B, K),
        predictive perplexity)``."""
        theta, ev_ll = self._run(word_ids, est_counts, ev_counts, seed,
                                 theta0)
        ppl = float(np.exp(-float(ev_ll) / max(float(ev_counts.sum()), 1.0)))
        return theta, ppl

    def infer_stream(
        self, corpus: DocWordMatrix, doc_ids: Sequence[int],
        batch_size: int, seed: int = 0, bucket_multiple: int = 16,
    ) -> Iterator[Tuple[Sequence[int], np.ndarray]]:
        """Batched/bucketized streaming inference over a request stream.

        Packs ``doc_ids`` into fixed-size (batch_size, L) buckets (L rounds
        up to ``bucket_multiple``; short tail batches pad with empty
        documents), seeds batch i's init from ``(seed, i)`` (the stream is
        deterministic end to end) and yields
        ``(chunk_doc_ids, theta (len(chunk), K))``.
        """
        ids = list(doc_ids)
        for i, lo in enumerate(range(0, len(ids), batch_size)):
            chunk = ids[lo: lo + batch_size]
            w, c = bucketize(corpus, chunk, pad_multiple=bucket_multiple)
            if len(chunk) < batch_size:      # tail: pad with empty docs
                padding = batch_size - len(chunk)
                w = np.concatenate([w, np.zeros((padding, w.shape[1]),
                                                w.dtype)])
                c = np.concatenate([c, np.zeros((padding, c.shape[1]),
                                                c.dtype)])
            theta = self.infer(w, c, seed=_batch_seed(seed, i))
            yield chunk, theta[: len(chunk)]


def _batch_seed(seed: int, index: int) -> int:
    """The init seed of batch ``index`` of a stream seeded with ``seed``."""
    return int(np.random.SeedSequence((int(seed), int(index)))
               .generate_state(1)[0])


# ---------------------------------------------------------------------------
# Synthetic traffic — Zipf word mix, Poisson arrivals
# ---------------------------------------------------------------------------


class TrafficGenerator:
    """Deterministic synthetic request traffic.

    Documents draw their tokens from a Zipf(``zipf_exponent``) word
    distribution over a seeded permutation of the vocabulary (the realistic
    skew the hot-row cache exploits); arrivals are Poisson — i.i.d.
    exponential gaps at each stage's rate — with ``stages`` giving a QPS
    ramp as ``(qps, num_requests)`` segments.  The same seed draws the same
    requests as the JAX package's generator.
    """

    def __init__(self, vocab_size: int, *,
                 zipf_exponent: float = 1.1,
                 doc_len: Tuple[int, int] = (16, 64),
                 seed: int = 0):
        self.vocab = int(vocab_size)
        self.doc_len = doc_len
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)  # lint: host-f64
        p = ranks ** -float(zipf_exponent)
        self._p = p / p.sum()
        self._word_of_rank = self.rng.permutation(self.vocab)

    def document(self) -> Tuple[np.ndarray, np.ndarray]:
        """One bag-of-words request: (unique word ids, counts)."""
        lo, hi = self.doc_len
        n_tokens = int(self.rng.integers(lo, hi + 1))
        ranks = self.rng.choice(self.vocab, size=n_tokens, p=self._p)
        uniq, counts = np.unique(self._word_of_rank[ranks],
                                 return_counts=True)
        return uniq.astype(np.int32), counts.astype(np.float32)

    def trace(self, stages: Sequence[Tuple[float, int]]
              ) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        """Precompute ``(arrival_seconds, word_ids, counts)`` requests for
        a QPS ramp of ``(qps, num_requests)`` stages."""
        out = []
        t = 0.0
        for qps, n in stages:
            gaps = self.rng.exponential(1.0 / float(qps), int(n))
            for g in gaps:
                t += float(g)
                w, c = self.document()
                out.append((t, w, c))
        return out

    def word_ranks(self) -> np.ndarray:
        """(W,) 1-based Zipf rank of each word id in this traffic."""
        ranks = np.empty(self.vocab, np.int64)
        ranks[self._word_of_rank] = np.arange(1, self.vocab + 1)
        return ranks

    def corpus(self, num_docs: int) -> DocWordMatrix:
        """``num_docs`` requests as a document-major sparse matrix."""
        docs = [self.document() for _ in range(num_docs)]
        lens = [len(w) for w, _ in docs]
        return DocWordMatrix(
            indptr=np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
            word_ids=np.concatenate([w for w, _ in docs]),
            counts=np.concatenate([c for _, c in docs]),
            vocab_size=self.vocab,
        )


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def make_store(workdir: str, vocab: int, topics: int, *, seed: int = 0
               ) -> ParameterStore:
    """Write a trained-like φ̂ store (``trained_like_phi_blocks``) at
    ``workdir`` — random weights from ``seed``, for running the server
    without a training run."""
    return store_from_arrays(
        workdir, trained_like_phi_blocks(vocab, topics, seed=seed), None,
        live_vocab=vocab, vocab_capacity=vocab,
    )


def serve_lda(args) -> None:
    cfg = LDAConfig(num_topics=args.topics, vocab_size=args.vocab)
    if args.make_store and not os.path.exists(
            os.path.join(args.workdir, ParameterStore.BACKING)):
        make_store(args.workdir, args.vocab, args.topics, seed=args.seed)
    store = ParameterStore(args.workdir, num_topics=args.topics,
                           vocab_capacity=args.vocab,
                           buffer_rows=args.buffer_rows)
    if store.phi_k.sum() == 0:
        raise SystemExit(
            f"no trained φ̂ under {args.workdir}; write one first "
            "(--make-store draws a trained-like one)"
        )
    server = TopicServer(store, cfg, active_topics=args.active_topics,
                         phi_dtype=args.phi_dtype, hot_rows=args.hot_rows,
                         device=args.device)
    # Requests: Zipf traffic (the JAX CLI draws an LDA corpus, whose dense
    # (K, W) topic draw does not scale to full-width models)
    gen = TrafficGenerator(args.vocab, doc_len=(args.min_len, args.max_len),
                           seed=123)
    corpus = gen.corpus(args.requests)
    ids = list(range(corpus.num_docs))
    t0 = time.time()
    for chunk, theta in server.infer_stream(corpus, ids, args.batch,
                                            seed=args.seed):
        top = np.argsort(-theta, axis=1)[:, :3]
        if chunk[0] == ids[0]:
            for d in range(min(4, len(chunk))):
                mix = ", ".join(
                    f"k{int(k)}:{theta[d, k]:.2f}" for k in top[d]
                )
                print(f"  doc{chunk[d]:4d} top topics: {mix}")
    dt = time.time() - t0
    print(f"served {len(ids)} docs in {dt:.2f}s "
          f"({len(ids)/dt:.1f} docs/s, batch={args.batch}, "
          f"{server.last_sweeps} fixed-point sweeps on the last batch, "
          f"device={server.device})")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve LDA topic mixtures from a parameter store.")
    ap.add_argument("--workdir", required=True,
                    help="parameter store directory")
    ap.add_argument("--topics", type=int, default=100)
    ap.add_argument("--vocab", type=int, default=5000)
    ap.add_argument("--buffer-rows", type=int, default=2048)
    ap.add_argument("--active-topics", type=int, default=0,
                    help="restrict each word's fit support to its top-A "
                         "topics by trained φ mass (0 = dense fit)")
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--min-len", type=int, default=16,
                    help="fewest tokens in a request")
    ap.add_argument("--max-len", type=int, default=64,
                    help="most tokens in a request")
    ap.add_argument("--phi-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"),
                    help="serving storage dtype of the frozen φ block")
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="capacity of the serving hot-word φ-row cache "
                         "(0 = disabled)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--make-store", action="store_true",
                    help="write a trained-like random φ̂ store of "
                         "--vocab × --topics into --workdir unless one "
                         "is there")
    serve_lda(ap.parse_args(argv))


if __name__ == "__main__":
    main()
