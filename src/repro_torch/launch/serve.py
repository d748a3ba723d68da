"""Serving driver — topic inference for unseen documents, the paper's
deployment mode (PyTorch port of ``repro.launch.serve``).

LDA serving = the E-step with FROZEN φ̂ (§2.4): per request batch, fit θ̂
only — the θ-only fixed point of eq. 11 with the φ M-step switched off —
and return the per-document topic mixture (eq. 9).  Requests stream
against the disk-backed parameter store (``ParameterStore``, optionally
behind a ``HotRowCache``); the fit routes through ``kernels.ops.infer``,
whose chunks run the hand-written Hopper kernel on the card.

    serve_lda (CLI) ─► TopicServer.infer_stream / infer / evaluate
       │                  │  localize_vocab → fetch φ̂ rows (HotRowCache →
       │                  │  ParameterStore) → pad W_s to vocab_pad
       │                  ▼
       │               _infer_local: eq. 10 with the global W → ops.infer
       │                  │  check_every-sweep chunks, rel_tol stop
       │                  ▼
       │               theta_sweep kernel (csrc/theta_sweep.cu)
       │
       └─ --traffic ─► serve_traffic: TrafficGenerator.replay → ServingEngine
                          AdmissionRouter (slots by L bucket, deadline
                          flush) → launcher thread: pad_batch →
                          document_theta0 (a seed per document) →
                          TopicServer.infer

Lifelong train-while-serve (``launch/lifelong.py``): a server subscribed to
a ``SnapshotPublisher`` (``TopicServer.subscribe``) serves committed φ
snapshot versions instead of the live store; the engine's launcher
hot-swaps to the newest one between launches (``TopicServer.refresh``), so
every launch reads one pinned epoch and every θ comes back stamped with
its version (``ThetaResult.version``).  Replicas come with a later slice.

Run the CLI on a GPU host with
``PYTHONPATH=src python -m repro_torch.launch.serve --workdir DIR --topics K
--vocab W [--make-store] [--traffic --qps Q [--pace]]``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import em
from repro_torch.core.perplexity import init_theta, serving_active_topics
from repro_torch.core.streaming import (
    HotRowCache,
    ParameterStore,
    PhiSnapshot,
    SnapshotPublisher,
    store_from_arrays,
)
from repro_torch.core.types import (
    InferPlan,
    LDAConfig,
    MinibatchData,
    uniform_responsibilities,
)
from repro_torch.data.synthetic import trained_like_phi_blocks
from repro_torch.kernels import ops as kops
from repro_torch.runtime.device import Device, resolve_device
from repro_torch.sparse.docword import DocWordMatrix, bucketize, localize_vocab


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class ThetaResult(np.ndarray):
    """A (K,) θ mixture stamped with the committed φ snapshot version that
    produced it (−1 when serving straight from the store, i.e. not
    subscribed to a publisher).  Behaves exactly like the plain ndarray;
    the version tag rides along as an attribute."""

    version: int = -1

    @staticmethod
    def wrap(theta: np.ndarray, version: int) -> "ThetaResult":
        out = np.asarray(theta).view(ThetaResult)
        out.version = int(version)
        return out


@dataclasses.dataclass(frozen=True)
class _ServingVersion:
    """One pinned, immutable φ epoch the server launches against.

    Holds the snapshot plus its (possibly quantized) serving storage —
    built once at hot-swap (``TopicServer.refresh``) and shared by every
    launch on this version.  In-flight launches keep their reference, so a
    concurrent swap never tears a batch: rows and ``phi_k`` always come
    from the same epoch.
    """

    snapshot: PhiSnapshot
    version: int
    phi_k: np.ndarray                  # (K,) float32
    values: object                     # (capacity, K) f32 / int8 ndarray, or
                                       # a CPU torch.bfloat16 tensor
    scale: Optional[np.ndarray]        # (capacity,) f32 int8 scales, or None

    def fetch_rows(self, word_ids: np.ndarray) -> np.ndarray:
        """Dequantized f32 rows of THIS version (never the live store)."""
        ids = np.asarray(word_ids, np.int64)
        if isinstance(self.values, torch.Tensor):        # bf16 storage
            rows = self.values[torch.from_numpy(ids)].float().numpy()
        else:
            rows = np.asarray(self.values[ids], np.float32)
        if self.scale is not None:
            rows = rows * self.scale[ids][:, None]
        return rows


def _changed_since(pub: SnapshotPublisher, cur: Optional[_ServingVersion],
                   snap: PhiSnapshot) -> Optional[np.ndarray]:
    """Rows that differ between the pinned epoch ``cur`` and ``snap``: the
    ids the hot-row cache must drop when the server swaps.

    ``snap``'s own delta when it is the next version; the union of every
    delta since ``cur`` when the launcher skipped versions; ``None`` (drop
    everything) on the first swap, whose cache rows came from the store,
    or when a skipped version has aged out of the publisher.  (The JAX
    package drops only ``snap``'s delta, so after a skipped version its
    cache can serve a row that version changed from the older epoch.)
    """
    if cur is None:
        return None
    deltas = [pub.get(v) for v in range(cur.version + 1, snap.version)]
    if any(d is None for d in deltas):
        return None
    return np.unique(np.concatenate(
        [d.changed_ids for d in deltas] + [snap.changed_ids]))


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

    Lifelong mode: after ``subscribe(publisher)`` the server reads
    committed φ snapshots only, never the store; ``refresh()`` hot-swaps to
    the newest version (``swap_log`` keeps one record a swap) and
    ``last_version`` is the version the last call used.
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
        # --- lifelong publish/subscribe state ---
        self._publisher: Optional[SnapshotPublisher] = None
        self._active: Optional[_ServingVersion] = None   # pinned epoch
        self.swap_log: List[dict] = []       # one record per hot-swap
        self.last_version = -1               # version the last launch used

    # -------------------------------------------------- lifelong hot-swap

    def subscribe(self, publisher: SnapshotPublisher,
                  refresh: bool = True) -> None:
        """Serve committed φ snapshot versions from ``publisher`` instead
        of the live store — the lifelong train-while-serve mode.  Once
        subscribed, launches never read store rows again: a concurrent
        trainer can write freely and the server only moves at
        ``refresh()`` (called between launches by the engine)."""
        self._publisher = publisher
        if refresh:
            self.refresh()

    def refresh(self) -> bool:
        """Hot-swap to the newest published version, if any.  Verifies the
        snapshot's crc manifest, (re)builds the quantized serving storage,
        installs the new epoch in the hot-row cache (dropping only the rows
        the publish changed), and atomically replaces the pinned epoch.  In
        flight launches finish on the old version they captured.  Returns
        True iff a swap happened; raises on a snapshot that fails its crc."""
        pub = self._publisher
        if pub is None:
            return False
        snap = pub.latest()
        if snap is None:
            return False
        cur = self._active
        if cur is not None and cur.version == snap.version:
            return False
        t0 = time.perf_counter()
        if not snap.verify():
            raise RuntimeError(
                f"φ snapshot v{snap.version} fails its crc manifest — "
                "torn or mutated publish; refusing to swap"
            )
        values, scale = snap.quantize(self.phi_dtype)   # re-quantize on swap
        if self.hot_cache is not None:
            self.hot_cache.install_version(
                snap.version, changed_ids=_changed_since(pub, cur, snap)
            )
        sv = _ServingVersion(
            snapshot=snap,
            version=snap.version,
            phi_k=np.asarray(snap.phi_k, np.float32),
            values=values,
            scale=scale,
        )
        self._active = sv                    # the atomic swap point
        self.swap_log.append({
            "version": snap.version,
            "seconds": time.perf_counter() - t0,
            "changed_rows": int(len(snap.changed_ids)),
        })
        return True

    # ------------------------------------------------------------ inference

    def _fetch_rows(self, uniq: np.ndarray,
                    active: Optional[_ServingVersion] = None) -> np.ndarray:
        if self.hot_cache is not None:
            if active is not None:
                return self.hot_cache.fetch(
                    uniq, source=active, version=active.version
                )
            return self.hot_cache.fetch(uniq)
        if active is not None:
            return active.fetch_rows(uniq)
        return self.store.fetch_rows(uniq)

    def _run(self, word_ids: np.ndarray, counts: np.ndarray,
             ev_counts: Optional[np.ndarray], seed: int, theta0):
        t0 = time.perf_counter()
        # pin ONE epoch for the whole launch: rows and phi_k below both come
        # from `active`, so a concurrent refresh() can never tear the batch
        active = self._active
        uniq, local = localize_vocab(np.asarray(word_ids))
        rows = self._fetch_rows(uniq, active)              # streamed φ̂
        # pad the local vocab to a bucket boundary so batches share shapes
        # (padded rows are never indexed by `local`)
        pad = _round_up(len(uniq), self.vocab_pad) - len(uniq)
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((pad, rows.shape[1]), rows.dtype)]
            )
        t1 = time.perf_counter()
        theta, sweeps, ev_ll = _infer_local(
            local, counts, ev_counts, rows,
            active.phi_k if active is not None else self.store.phi_k,
            self.cfg,
            fit_sweeps=self.fit_sweeps, check_every=self.check_every,
            rel_tol=self.rel_tol, active_topics=self.active_topics,
            phi_dtype=self.phi_dtype, seed=seed, theta0=theta0,
            device=self.device,
        )
        theta = theta.cpu().numpy()          # waits for the device
        self.last_sweeps = int(sweeps)
        self.last_version = active.version if active is not None else -1
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
            theta = self.infer(w, c, seed=_sub_seed(seed, i))
            yield chunk, theta[: len(chunk)]


def _sub_seed(seed: int, index: int) -> int:
    """The init seed of item ``index`` (a stream's batch, an engine's
    document) under ``seed``: a uint32 from ``SeedSequence((seed, index))``."""
    return int(np.random.SeedSequence((int(seed), int(index)))
               .generate_state(1)[0])


def document_theta0(seeds, counts, cfg: LDAConfig, *,
                    device: Device = "cuda") -> torch.Tensor:
    """Per-document θ̂₀ of a (B, L) batch: (B, K) on ``device``.

    Row i folds the counts of document i through μ₀ drawn as
    ``uniform_responsibilities`` over (L, K) from a generator seeded with
    ``seeds[i]`` alone; a negative seed marks an empty slot, whose θ̂₀ is 0.
    Each row is computed by the same operations on same-shaped tensors
    whatever its slot and batch-mates, so it is bitwise a function of its
    seed, its counts and L.
    """
    dev = resolve_device(device)
    counts = torch.as_tensor(counts).to(device=dev, dtype=cfg.dtype)
    B, L = counts.shape
    theta = torch.zeros((B, cfg.K), dtype=cfg.dtype, device=dev)
    gen = torch.Generator(device=dev)
    for i, s in enumerate(np.asarray(seeds, np.int64).tolist()):
        if s < 0:
            continue
        gen.manual_seed(s)
        mu0 = uniform_responsibilities(gen, (L, cfg.K), cfg.dtype)
        theta[i] = (mu0 * counts[i, :, None]).sum(0)
    return theta


# ---------------------------------------------------------------------------
# Continuous batching — the high-throughput serving engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Request:
    """One admitted document, waiting in an in-flight slot."""

    seq: int
    word_ids: np.ndarray         # (n,) token word ids (unpadded)
    counts: np.ndarray           # (n,) token counts
    seed: int                    # per-document θ̂₀ seed (uint32)
    future: Future
    t_submit: float


def pad_batch(L: int, reqs: Sequence[_Request], max_batch: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a flushed bucket to its ``(max_batch, L)`` launch shape:
    ``(word_ids, counts, seeds)``.

    Tail slots are empty documents (exactly like ``infer_stream``'s tail
    padding) with seed −1, whose θ̂₀ is 0 (:func:`document_theta0`).  The
    padded arrays, not the request list, are the launch's whole input:
    re-issuing them reproduces the launch bitwise.  Under ``rel_tol > 0``
    the convergence stop is batch-global, so re-issue parity requires the
    same padded batch, never a repacking of its documents.
    """
    w = np.zeros((max_batch, L), np.int32)
    c = np.zeros((max_batch, L), np.float32)
    seeds = np.full(max_batch, -1, np.int64)
    for i, r in enumerate(reqs):
        w[i, : len(r.word_ids)] = r.word_ids
        c[i, : len(r.counts)] = r.counts
        seeds[i] = r.seed
    return w, c, seeds


class AdmissionRouter:
    """Deadline-aware admission front: in-flight slots, a collector thread
    and a bounded flush queue, decoupled from whatever runs the batches.

    * ``submit`` (caller thread) appends the request to the in-flight
      slots of its document-length bucket — O(1) under a lock — stamps a
      per-document θ̂₀ seed, and returns a Future;
    * the *collector* thread flushes a bucket into the bounded queue when
      it fills ``max_batch`` slots, or when its **oldest** request has
      waited ``max_delay_ms`` (deadline-aware: a straggling slot never
      holds a full bucket hostage, a lone request never waits more than
      the deadline);
    * the single consumer (the engine's launcher thread) pulls
      ``(L, reqs)`` items with :meth:`next_batch` and reports outcomes
      through :meth:`resolve_batch` / :meth:`fail_batch`, which keep the
      resolved/latency/batch accounting that :meth:`drain` and
      :meth:`metrics` read.

    ``close()`` is idempotent and safe under concurrent callers: every
    caller blocks until the collector is joined, so nobody can observe a
    half-stopped router.
    """

    def __init__(self, *, max_batch: int = 64, bucket_multiple: int = 16,
                 max_delay_ms: float = 5.0, max_len: int = 256,
                 queue_depth: int = 4, seed: int = 0):
        self.max_batch = int(max_batch)
        self.bucket_multiple = int(bucket_multiple)
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_len = int(max_len)
        self.queue_depth = int(queue_depth)
        self.seed = int(seed)
        self._pending: dict = {}             # L bucket -> list[_Request]
        self._seq = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._stop = False
        self._resolved = 0                   # futures resolved (ok or error)
        self.failed_batches = 0              # buckets resolved with an error
        self.latencies: List[float] = []     # per request, submit -> resolve
        self.batch_log: List[dict] = []      # per launched batch
        self._collector = threading.Thread(
            target=self._collect_loop, name="serve-collector", daemon=True
        )
        self._collector.start()

    # ------------------------------------------------------------- admission

    def _bucket(self, n: int) -> int:
        return _round_up(max(n, 1), self.bucket_multiple)

    def submit(self, word_ids: np.ndarray,
               counts: Optional[np.ndarray] = None,
               seed: Optional[int] = None) -> Future:
        """Admit one document; resolves to its (K,) normalized θ (eq. 9).
        ``seed`` overrides the document's θ̂₀ seed (default: derived from
        the router's seed and the admission number)."""
        w = np.asarray(word_ids, np.int32).ravel()
        c = (np.ones(len(w), np.float32) if counts is None
             else np.asarray(counts, np.float32).ravel())
        if len(w) > self.max_len:
            raise ValueError(
                f"document has {len(w)} tokens > engine max_len "
                f"{self.max_len}; raise max_len at construction"
            )
        fut: Future = Future()
        with self._cond:
            if self._stop:
                raise RuntimeError("admission router is closed")
            seq = self._seq
            self._seq += 1
            req = _Request(seq, w, c,
                           _sub_seed(self.seed, seq) if seed is None
                           else int(seed),
                           fut, time.perf_counter())
            self._pending.setdefault(self._bucket(len(w)), []).append(req)
            self._cond.notify()
        return fut

    # ------------------------------------------------------------- collector

    def _collect_loop(self) -> None:
        while True:
            flush: List[Tuple[int, List[_Request]]] = []
            with self._cond:
                while True:
                    if self._stop and not self._pending:
                        break
                    now = time.perf_counter()
                    deadline = None
                    for L, reqs in self._pending.items():
                        if len(reqs) >= self.max_batch or self._stop:
                            flush.append((L, reqs[: self.max_batch]))
                            self._pending[L] = reqs[self.max_batch:]
                            continue
                        age_out = reqs[0].t_submit + self.max_delay
                        if age_out <= now:
                            flush.append((L, reqs))
                            self._pending[L] = []
                        elif deadline is None or age_out < deadline:
                            deadline = age_out
                    self._pending = {
                        L: r for L, r in self._pending.items() if r
                    }
                    if flush or (self._stop and not self._pending):
                        break
                    self._cond.wait(
                        timeout=None if deadline is None else deadline - now
                    )
                stopping = self._stop and not self._pending
            for item in flush:       # bounded put OUTSIDE the lock:
                self._queue.put(item)  # backpressure must not stall submit()
            if stopping and not flush:
                self._queue.put(None)
                return

    # -------------------------------------------------------------- consumer

    def next_batch(self) -> Optional[Tuple[int, List[_Request]]]:
        """Block for the next flushed ``(L, reqs)`` bucket.  ``None`` is
        the shutdown sentinel: admission stopped and every pending slot
        has been flushed ahead of it."""
        return self._queue.get()

    def resolve_batch(self, reqs: Sequence[_Request], thetas,
                      version: int, rec: dict) -> None:
        """Resolve a launched bucket and commit its accounting (batch
        record + per-request latencies).  Resolutions are counted one by
        one: if ``set_result`` ever raises mid-loop (a cancelled future),
        the already-resolved prefix still reaches ``_resolved``, or
        ``drain()`` would wait forever on the lost counts."""
        t1 = time.perf_counter()
        ok = 0
        try:
            for i, r in enumerate(reqs):
                r.future.set_result(
                    ThetaResult.wrap(np.array(thetas[i]), version)
                )
                ok += 1
        finally:
            with self._lock:
                self._resolved += ok
                self.batch_log.append(rec)
                self.latencies.extend(t1 - r.t_submit for r in reqs)

    def fail_batch(self, reqs: Sequence[_Request],
                   exc: BaseException) -> None:
        """Resolve a failed bucket with ``exc`` — never hang the callers."""
        n_err = 0
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)
                n_err += 1
        with self._lock:
            self._resolved += n_err
            self.failed_batches += 1

    # ------------------------------------------------------------ accounting

    def metrics(self, reset: bool = False) -> dict:
        """Latency/throughput/cache summary over the recorded window."""
        with self._lock:
            lats = np.asarray(self.latencies, np.float64)  # lint: host-f64
            log = list(self.batch_log)
            failed = self.failed_batches
            if reset:
                self.latencies = []
                self.batch_log = []
        out = {
            "requests": int(lats.size),
            "batches": len(log),
            "failed_batches": failed,
            "mean_fill": (
                float(np.mean([b["filled"] for b in log])) if log else 0.0
            ),
            "cache_hits": int(sum(b["cache_hits"] for b in log)),
            "cache_misses": int(sum(b["cache_misses"] for b in log)),
        }
        # staleness actually observed: how many committed versions behind
        # the newest publish each launch served (lifelong mode only)
        stale = [
            b["published_version"] - b["version"]
            for b in log
            if b.get("version", -1) >= 0
            and b.get("published_version", -1) >= 0
        ]
        if stale:
            out["max_staleness_versions"] = int(max(stale))
        if lats.size:
            out.update(
                p50_ms=float(np.percentile(lats, 50) * 1e3),
                p99_ms=float(np.percentile(lats, 99) * 1e3),
                mean_ms=float(lats.mean() * 1e3),
            )
        return out

    def drain(self) -> None:
        """Block until every admitted request has resolved."""
        while True:
            with self._lock:
                idle = not self._pending and self._queue.empty()
                resolved, admitted = self._resolved, self._seq
            if idle and resolved >= admitted:
                return
            time.sleep(0.001)

    def close(self) -> None:
        """Stop admission, flush the remaining slots, join the collector.

        Idempotent and safe under concurrent callers: every caller blocks
        on the join (``Thread.join`` is multi-caller safe), so no caller
        returns while the collector is still flushing.
        """
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._collector.join()


def prewarm_server(srv: TopicServer, *, max_batch: int,
                   bucket_multiple: int, max_len: int,
                   lengths: Optional[Sequence[int]] = None) -> int:
    """One full ``(max_batch, L)`` launch per reachable L bucket, before
    traffic: the kernel build, the allocator's blocks and the hot-row
    cache warm up here and not under a request's deadline.  There is no
    trace cache to fill (the JAX package compiles a grid of shapes here).

    ``lengths`` defaults to the ``bucket_multiple`` grid up to ``max_len``;
    a length off the grid is skipped.  Every document of a launch reads
    words 0 … L − 1 (mod the store's rows): a cheap fetch.  Returns the
    launch count, and resets the cache and store stat windows so warm-up
    traffic does not pollute the serving counters.
    """
    kops.refuse_debug_checks(srv.cfg.debug_checks, "prewarm_server")
    if lengths is None:
        lengths = range(bucket_multiple, max_len + 1, bucket_multiple)
    rows = min(srv.cfg.W, srv.store.capacity)
    count = 0
    for L in lengths:
        if _round_up(max(L, 1), bucket_multiple) != L:
            continue
        w = np.tile(np.arange(L) % rows, (max_batch, 1)).astype(np.int32)
        c = np.ones_like(w, np.float32)
        srv.infer(w, c, theta0=document_theta0(
            np.arange(max_batch), c, srv.cfg, device=srv.device))
        count += 1
    if srv.hot_cache is not None:
        srv.hot_cache.reset_stats()
    srv.store.stats_window(reset=True)
    return count


class ServingEngine:
    """Continuous batching over :class:`TopicServer`.

    Admission (in-flight slots, deadline-aware collector, bounded launch
    queue, per-document θ̂₀ seeds) is an :class:`AdmissionRouter`; the
    engine adds the single *launcher* thread that consumes flushed
    buckets, pads each to its (``max_batch``, L-bucket) shape
    (:func:`pad_batch`), draws every document's θ̂₀ from its own seed
    (:func:`document_theta0`) and runs one ``TopicServer.infer`` per
    bucket on the server's device.  Admission never blocks on compute: the
    bounded queue is the only backpressure.  A launch that raises resolves
    every future of its bucket with the exception (``fail_batch``).

    A document's θ is thereby independent of which slot and batch the
    collector packed it into — continuous batching is semantically
    invisible (bitwise, under ``rel_tol=0``: the θ-sweep keeps documents
    independent of their batch-mates).  ``prewarm()`` runs one launch per
    L bucket up front (:func:`prewarm_server`).

    Before each launch the launcher calls ``server.refresh()``: a
    subscribed server hot-swaps to the newest committed φ version between
    launches, never during one (a snapshot that fails its crc fails that
    bucket's futures).  Every ``batch_log`` entry records the ``version``
    the launch served and the publisher's ``published_version`` after it
    (both −1 when the server reads the store), and every θ resolves as a
    ``ThetaResult`` stamped with its version.
    """

    def __init__(self, server: TopicServer, *,
                 max_batch: int = 64,
                 bucket_multiple: int = 16,
                 max_delay_ms: float = 5.0,
                 max_len: int = 256,
                 queue_depth: int = 4,
                 seed: int = 0):
        kops.refuse_debug_checks(server.cfg.debug_checks, "ServingEngine")
        self.server = server
        self.router = AdmissionRouter(
            max_batch=max_batch, bucket_multiple=bucket_multiple,
            max_delay_ms=max_delay_ms, max_len=max_len,
            queue_depth=queue_depth, seed=seed,
        )
        self.max_batch = self.router.max_batch
        self.bucket_multiple = self.router.bucket_multiple
        self.max_delay = self.router.max_delay
        self.max_len = self.router.max_len
        self.queue_depth = self.router.queue_depth
        self._launcher = threading.Thread(
            target=self._launch_loop, name="serve-launcher", daemon=True
        )
        self._launcher.start()

    # ------------------------------------------------------------- admission

    # Accounting lives on the router; these delegations keep the engine's
    # surface (eng._resolved, eng._seq, eng.batch_log, eng.latencies).

    @property
    def _resolved(self) -> int:
        return self.router._resolved

    @property
    def _seq(self) -> int:
        return self.router._seq

    @property
    def batch_log(self) -> List[dict]:
        return self.router.batch_log

    @property
    def latencies(self) -> List[float]:
        return self.router.latencies

    def _bucket(self, n: int) -> int:
        return self.router._bucket(n)

    def submit(self, word_ids: np.ndarray, counts: Optional[np.ndarray] = None,
               seed: Optional[int] = None) -> Future:
        """Admit one document; resolves to its (K,) normalized θ (eq. 9)."""
        return self.router.submit(word_ids, counts, seed)

    # -------------------------------------------------------------- launcher

    def _launch_loop(self) -> None:
        dev = self.server.device
        # this thread's current device is the server's, for every launch
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            while True:
                item = self.router.next_batch()
                if item is None:
                    return
                L, reqs = item
                try:
                    # hot-swap point: the launcher is the only thread that
                    # launches, so swapping BETWEEN launches means no
                    # launch ever straddles two versions
                    self.server.refresh()
                    self._launch(L, reqs)
                except Exception as e:   # resolve, never hang the callers
                    self.router.fail_batch(reqs, e)

    def _launch(self, L: int, reqs: List[_Request]) -> None:
        w, c, seeds = pad_batch(L, reqs, self.max_batch)
        t0 = time.perf_counter()
        theta0 = document_theta0(seeds, c, self.server.cfg,
                                 device=self.server.device)
        theta = self.server.infer(w, c, theta0=theta0)
        t1 = time.perf_counter()
        version = self.server.last_version
        pub = self.server._publisher
        cache = self.server.hot_cache
        cw = cache.window_stats() if cache is not None else None
        rec = {
            "L": L, "filled": len(reqs), "capacity": self.max_batch,
            "launch_seconds": t1 - t0,
            "fetch_seconds": self.server.last_seconds["fetch"],
            "fit_seconds": self.server.last_seconds["fit"],
            "sweeps": self.server.last_sweeps,
            "cache_hits": cw.hits if cw else 0,
            "cache_misses": cw.misses if cw else 0,
            # staleness audit trail: the version this launch served vs the
            # newest committed version at launch end
            "version": version,
            "published_version": pub.version if pub is not None else -1,
        }
        self.router.resolve_batch(reqs, theta, version, rec)

    # -------------------------------------------------------------- plumbing

    def prewarm(self, lengths: Optional[Sequence[int]] = None) -> int:
        """One launch per L bucket up front (:func:`prewarm_server`);
        returns the launch count."""
        return prewarm_server(self.server, max_batch=self.max_batch,
                              bucket_multiple=self.bucket_multiple,
                              max_len=self.max_len, lengths=lengths)

    def metrics(self, reset: bool = False) -> dict:
        """Latency/throughput/cache summary over the recorded window."""
        return self.router.metrics(reset=reset)

    def drain(self) -> None:
        """Block until every admitted request has resolved."""
        self.router.drain()

    def close(self) -> None:
        """Flush remaining slots, stop both threads.

        Idempotent and safe under concurrent callers: every caller blocks
        until both the collector and the launcher are joined.
        """
        self.router.close()
        self._launcher.join()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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

    @staticmethod
    def replay(trace, submit, pace: bool = True) -> List[Future]:
        """Drive ``submit(word_ids, counts)`` with a precomputed trace.

        ``pace=True`` honours the arrival timestamps (open-loop latency
        measurement: late arrivals are submitted immediately, queueing
        delay counts against the server); ``pace=False`` submits
        back-to-back (closed-loop sustained-throughput measurement).
        """
        futures = []
        t0 = time.perf_counter()
        for t_arr, w, c in trace:
            if pace:
                delay = t0 + t_arr - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            futures.append(submit(w, c))
        return futures

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


def serve_traffic(args, server: TopicServer) -> None:
    """Drive the continuous-batching engine with synthetic Zipf/Poisson
    traffic and report the latency and throughput numbers (p50/p99
    latency, documents/s, batches and their fill, cache)."""
    gen = TrafficGenerator(args.vocab, doc_len=(args.min_len, args.max_len),
                           seed=123)
    trace = gen.trace([(args.qps, args.requests)])
    with ServingEngine(server, max_batch=args.batch,
                       max_delay_ms=args.max_delay_ms,
                       max_len=_round_up(gen.doc_len[1], 16),
                       seed=args.seed) as eng:
        warm = eng.prewarm()
        t0 = time.time()
        futs = TrafficGenerator.replay(trace, eng.submit, pace=args.pace)
        for f in futs:
            f.result()
        dt = time.time() - t0
        eng.drain()                      # the last batch's accounting
        m = eng.metrics()
    print(f"served {m['requests']} requests in {dt:.2f}s "
          f"({m['requests']/dt:.1f} docs/s sustained, target {args.qps} "
          f"QPS, {'paced' if args.pace else 'unpaced'}; {warm} warm-up "
          f"launches, device={server.device})")
    print(f"  latency p50 {m.get('p50_ms', 0):.1f}ms  "
          f"p99 {m.get('p99_ms', 0):.1f}ms  "
          f"batches {m['batches']} (mean fill {m['mean_fill']:.1f})")
    if server.hot_cache is not None:
        s = server.hot_cache.stats
        print(f"  hot-row cache: {s.hits} hits / {s.misses} misses "
              f"({100 * s.hit_rate:.1f}%)")


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
    if args.traffic:
        serve_traffic(args, server)
        return
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
    ap.add_argument("--batch", type=int, default=64,
                    help="documents a launch (the engine's max_batch)")
    ap.add_argument("--traffic", action="store_true",
                    help="drive the continuous-batching engine with "
                         "synthetic Zipf/Poisson traffic and report "
                         "p50/p99 latency and sustained documents/s")
    ap.add_argument("--qps", type=float, default=200.0,
                    help="offered request rate for --traffic")
    ap.add_argument("--pace", action="store_true",
                    help="honour arrival timestamps (open-loop latency "
                         "run) instead of submitting back-to-back")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="continuous-batching flush deadline")
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
