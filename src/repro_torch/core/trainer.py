"""FOEMTrainer — the single-host streaming runtime (paper Fig. 4 + §3.2),
PyTorch port of ``repro.core.trainer``.

Per minibatch:
  1. vocab-major reorganisation (``localize_vocab``) → W_s unique words;
  2. fetch exactly those φ̂ rows from the ParameterStore (disk/host tier,
     LRU-buffered) — parameter streaming;
  3. run the FOEM inner loop (``foem.foem_minibatch``) on the (W_s, K)
     local view, on the device;
  4. write the updated rows back, update the (K,) topic totals (a host
     float64 accumulator), advance the stream cursor, optionally flush
     (the fault-tolerant restart point).

``algorithm="sem"`` runs SEM's inner loop (``sem.sem_step``) in step 3
instead, with its eq. 33 / eq. 20 merge on the local view.

The FOEM topic totals.  The store's φ̂(k) grows by the step's row
increment, summed in float64 over the W_s rows: words outside the
minibatch do not change, so that is the exact change of Σ_w φ̂_w.  The JAX
package stores the inner loop's float32 running total instead, which drifts
from its rows (by +54 tokens in one dense sweep at the stream_1k width on
an H100) and would walk the store's φ̂(k) away from its rows over a stream.
SEM keeps the JAX package's arithmetic: under ``rho_mode="stepwise"`` its
(1 − ρ) decay of φ̂(k) is global while the rows decay only over W_s.

With ``prefetch_depth > 0``, stages 1-2 for minibatch s+1 run on a
background thread while the device computes minibatch s, and stage 4's
write-back is reconciled against in-flight fetches (see
``streaming.StreamPrefetcher``): the results are bitwise identical to the
synchronous loop.

Lifelong train-while-serve (``launch/lifelong.py``): after the write-back
a step publishes a committed φ snapshot every ``publish_every`` steps
through a ``streaming.SnapshotPublisher``, and feeds a
``scheduling.ShiftDetector`` its residual mass, train perplexity and the
store's new float64 φ(k); a shift the detector latched gives the next step
``refresh_extra_sweeps`` more warm-up (dense) sweeps.  Both loops publish
alike, since both go through ``_step_with_rows``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import foem, sem
from repro_torch.core.streaming import ParameterStore, StreamPrefetcher
from repro_torch.core.types import GlobalStats, LDAConfig, MinibatchData
from repro_torch.kernels import ops as kops
from repro_torch.runtime import faults as fault_lib
from repro_torch.runtime.device import Device, resolve_device
from repro_torch.sparse.minibatch import Minibatch


@dataclasses.dataclass
class StepMetrics:
    step: int
    sweeps: int
    train_ppl: float
    seconds: float
    disk_reads: int
    disk_writes: int
    buffer_hits: int
    prefetch_hit: bool = False      # rows were staged before we needed them
    overlap_seconds: float = 0.0    # host I/O hidden behind device compute
    residual_mass: float = float("nan")  # eq. 36 Σ r_w at sweep exit
    published_version: int = -1     # φ snapshot published at this step (-1: none)
    shift_events: Tuple = ()        # ShiftEvents the detector fired this step
    scheduler_refresh: bool = False  # step ran with extra warm-up sweeps
    # host seconds of the step's three stages: the row fetch (the queue
    # wait when prefetched), the device compute (host→device copies, the
    # inner loop, device→host copies) and the store write-back
    fetch_seconds: float = 0.0
    compute_seconds: float = 0.0
    writeback_seconds: float = 0.0


class FOEMTrainer:
    """Streaming FOEM (or SEM) with disk-backed parameters (the paper's
    full system).

    ``device`` (default ``"cuda"``, which raises without a GPU) runs the
    inner loop; its μ₀ draws come from a ``torch.Generator`` on that device
    seeded with ``seed``.  ``mu0_fn(minibatch)``, when given, supplies each
    step's (D, L, K) μ₀ instead (the cross-package tests pass the JAX
    package's).  ``algorithm`` is ``"foem"`` or ``"sem"`` (SEM's steps
    report ``residual_mass`` NaN: it has no residual scheduler).

    Lifelong knobs: ``publisher`` (a ``SnapshotPublisher``) publishes a
    committed snapshot after every ``publish_every``-th step;
    ``shift_detector`` (a ``ShiftDetector``) is fed each step's signals,
    and a shift it latched runs the next step with ``warmup_sweeps +
    refresh_extra_sweeps`` warm-up sweeps (at most ``max_sweeps``).
    """

    def __init__(
        self,
        cfg: LDAConfig,
        store: ParameterStore,
        *,
        seed: int = 0,
        checkpoint_every: int = 0,
        algorithm: str = "foem",
        prefetch_depth: int = 1,    # 0 = fully synchronous host I/O
        faults: Optional[fault_lib.FaultPlan] = None,
        mu0_fn: Optional[Callable[[Minibatch], np.ndarray]] = None,
        device: Device = "cuda",
        publisher=None,             # streaming.SnapshotPublisher | None
        publish_every: int = 0,     # publish a φ snapshot every N steps
        shift_detector=None,        # scheduling.ShiftDetector | None
        refresh_extra_sweeps: int = 2,  # extra warm-ups on a detected shift
    ):
        if store.K != cfg.K:
            raise ValueError("store/config topic count mismatch")
        if algorithm not in ("foem", "sem"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        kops.refuse_debug_checks(cfg.debug_checks, "FOEMTrainer")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.store = store
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.checkpoint_every = checkpoint_every
        self.algorithm = algorithm
        self.prefetch_depth = int(prefetch_depth)
        self.faults = faults
        self.mu0_fn = mu0_fn
        self.publisher = publisher
        self.publish_every = int(publish_every)
        self.shift_detector = shift_detector
        self.refresh_extra_sweeps = int(refresh_extra_sweeps)
        # steps whose contribution a seeded "drop" fault discarded — the
        # re-issue queue a driver replays through MinibatchStream
        self.dropped_steps: List[int] = []
        self.history: List[StepMetrics] = []
        # cumulative store I/O counters at the last step boundary
        self._stats_base = store.bump_pipeline_stats()

    # ------------------------------------------------------------------

    def step(self, mb: Minibatch) -> StepMetrics:
        """Synchronous step: fetch → compute → write back."""
        t0 = time.perf_counter()
        phi_rows = self.store.fetch_rows(mb.local_vocab)           # (W_s, K)
        fetch = time.perf_counter() - t0
        return self._step_with_rows(mb, phi_rows, t0=t0,
                                    fetch_seconds=fetch)[0]

    def _step_with_rows(
        self,
        mb: Minibatch,
        phi_rows: np.ndarray,
        *,
        prefetch_hit: bool = False,
        overlap_seconds: float = 0.0,
        fetch_seconds: float = 0.0,
        t0: Optional[float] = None,
    ) -> Tuple[StepMetrics, np.ndarray]:
        """Run the inner loop on fetched rows and write back.

        Returns ``(metrics, new_rows)`` — new_rows feed the prefetch
        reconciliation log.  ``t0`` is when the step's host I/O started, so
        ``StepMetrics.seconds`` covers fetch + compute + write-back.
        """
        if t0 is None:
            t0 = time.perf_counter()
        # pre-probe: a "kill" raises before any state is touched; a "drop"
        # skips this minibatch entirely (contribution lost → re-issue queue)
        if self.faults is not None and self.faults.fire(
            fault_lib.PRE_PROBE, step=self.store.step
        ):
            return self._dropped_step(mb, t0), phi_rows
        self.store.ensure_vocab(int(mb.local_vocab.max(initial=0)))
        tc = time.perf_counter()
        dev = self.device
        batch = MinibatchData(
            word_ids=torch.from_numpy(np.asarray(mb.local_word_ids,
                                                 np.int32)).to(dev),
            counts=torch.from_numpy(np.asarray(mb.counts,
                                               np.float32)).to(dev),
        )
        rows = torch.from_numpy(np.ascontiguousarray(phi_rows,
                                                     np.float32)).to(dev)
        phi_k = torch.from_numpy(self.store.phi_k.astype(np.float32)).to(dev)
        mu0 = self.mu0_fn(mb) if self.mu0_fn is not None else None
        refresh = (
            self.shift_detector.consume_refresh()
            if self.shift_detector is not None else False
        )
        cfg = self.cfg
        if refresh:
            # a detected shift grants extra full (unscheduled) warm-up
            # sweeps — the Fig. 4 residual re-initialisation mid-stream
            cfg = dataclasses.replace(cfg, warmup_sweeps=min(
                cfg.max_sweeps, cfg.warmup_sweeps + self.refresh_extra_sweeps))
        live_w = max(self.store.live_vocab, cfg.W)
        if self.algorithm == "sem":
            stats = GlobalStats(rows, phi_k,
                                torch.zeros((), dtype=torch.int32,
                                            device=dev))
            res, _, diag = sem.sem_step(
                self.generator, batch, stats, cfg, vocab_size=live_w,
                mu0=mu0, device=dev)
            res_mass = float("nan")         # no residual scheduler
            # the JAX package's arithmetic (module docstring)
            new_phi_k = res.phi_k.cpu().numpy().astype(np.float64)
        else:
            res = foem.foem_minibatch(
                self.generator, batch, rows, phi_k, cfg, vocab_size=live_w,
                mu0=mu0, device=dev,
            )
            diag = res.diag
            res_mass = float(diag.residual_mass)
            # the change of Σ_w φ̂_w: the rows' increment, summed in float64
            new_phi_k = self.store.phi_k + (
                res.phi_wk.sum(0, dtype=torch.float64)
                - rows.sum(0, dtype=torch.float64)).cpu().numpy()
        new_rows = res.phi_wk.cpu().numpy()
        ppl = float(diag.final_train_ppl)
        sweeps = int(diag.sweeps_run)
        del res, diag
        compute = time.perf_counter() - tc

        # post-fold: the local fold is complete but unpublished — a "kill"
        # here loses exactly this minibatch (the paper's restart unit); a
        # "drop" discards the fold without touching the store.
        if self.faults is not None and self.faults.fire(
            fault_lib.POST_FOLD, step=self.store.step
        ):
            return self._dropped_step(mb, t0), phi_rows

        # --- write back + advance cursor ---
        tw = time.perf_counter()
        self.store.write_rows(mb.local_vocab, new_rows)
        self.store.phi_k = new_phi_k
        self.store.step += 1
        if self.checkpoint_every and \
                self.store.step % self.checkpoint_every == 0:
            self.store.flush()
        writeback = time.perf_counter() - tw

        # --- lifelong: publish a committed φ snapshot on the cadence ---
        published = -1
        if (self.publisher is not None and self.publish_every
                and self.store.step % self.publish_every == 0):
            published = self.publisher.publish().version

        # --- topic-shift detection over this step's stream signals ---
        events: Tuple = ()
        if self.shift_detector is not None:
            events = tuple(self.shift_detector.update(
                step=self.store.step, residual_mass=res_mass,
                perplexity=ppl, phi_k=new_phi_k,
            ))

        base = self._stats_base
        self._stats_base = self.store.bump_pipeline_stats(
            overlap_seconds=overlap_seconds, prefetch_hit=prefetch_hit
        )
        m = StepMetrics(
            step=self.store.step,
            sweeps=sweeps,
            train_ppl=ppl,
            seconds=time.perf_counter() - t0,
            disk_reads=self._stats_base[0] - base[0],
            disk_writes=self._stats_base[1] - base[1],
            buffer_hits=self._stats_base[2] - base[2],
            prefetch_hit=prefetch_hit,
            overlap_seconds=overlap_seconds,
            residual_mass=res_mass,
            published_version=published,
            shift_events=events,
            scheduler_refresh=refresh,
            fetch_seconds=fetch_seconds,
            compute_seconds=compute,
            writeback_seconds=writeback,
        )
        self.history.append(m)
        return m, new_rows

    def _dropped_step(self, mb: Minibatch, t0: float) -> StepMetrics:
        """Account for a minibatch whose contribution a fault discarded.

        The store is untouched and the cursor still advances (the stream
        consumed the minibatch); the step index lands in ``dropped_steps``
        so a driver can re-issue it.  Metrics carry ``sweeps=0`` /
        ``ppl=nan``.
        """
        self.store.step += 1
        self.dropped_steps.append(self.store.step)
        base = self._stats_base
        self._stats_base = self.store.bump_pipeline_stats()
        m = StepMetrics(
            step=self.store.step,
            sweeps=0,
            train_ppl=float("nan"),
            seconds=time.perf_counter() - t0,
            disk_reads=self._stats_base[0] - base[0],
            disk_writes=self._stats_base[1] - base[1],
            buffer_hits=self._stats_base[2] - base[2],
        )
        self.history.append(m)
        return m

    # ------------------------------------------------------------------

    def fit_stream(
        self,
        stream: Iterator[Minibatch],
        max_steps: Optional[int] = None,
        callback: Optional[Callable[[StepMetrics], None]] = None,
    ) -> List[StepMetrics]:
        """Train on ``stream`` (at most ``max_steps`` minibatches), then
        flush the store."""
        if self.prefetch_depth > 0:
            return self._fit_stream_prefetched(stream, max_steps, callback)
        out = []
        for mb in stream:
            if max_steps is not None and len(out) >= max_steps:
                break
            m = self.step(mb)
            out.append(m)
            if callback:
                callback(m)
        self.store.flush()
        return out

    def _fit_stream_prefetched(
        self,
        stream: Iterator[Minibatch],
        max_steps: Optional[int],
        callback: Optional[Callable[[StepMetrics], None]],
    ) -> List[StepMetrics]:
        """Pipelined loop: the worker fetches minibatch s+1's rows (and runs
        the stream's bucketize/localize) while the device computes on s.

        A staged fetch may predate recent write-backs; every write is logged
        with its ``write_version`` and patched into older-versioned fetches
        before compute — results are bitwise-identical to the sync path.
        """
        out: List[StepMetrics] = []
        pf = StreamPrefetcher(self.store, stream, depth=self.prefetch_depth)
        # (version, ids, rows) of recent write-backs; a staged fetch can be
        # at most depth+1 writes behind.
        writes: deque = deque(maxlen=self.prefetch_depth + 2)
        it = iter(pf)
        try:
            while max_steps is None or len(out) < max_steps:
                t0 = time.perf_counter()   # step pays the (residual) I/O wait
                try:
                    staged, wait = next(it)
                except StopIteration:
                    break
                mb, rows = staged.minibatch, staged.phi_rows
                for ver, w_ids, w_rows in writes:
                    if ver > staged.version:
                        _, ia, ib = np.intersect1d(
                            mb.local_vocab, w_ids,
                            assume_unique=True, return_indices=True,
                        )
                        rows[ia] = w_rows[ib]
                # a hit means the rows were already staged when we arrived
                # (wait ≈ queue overhead); blocking for the fetch is a miss
                overlap = max(0.0, staged.fetch_seconds - wait)
                m, new_rows = self._step_with_rows(
                    mb, rows,
                    prefetch_hit=wait < 1e-3,
                    overlap_seconds=overlap,
                    fetch_seconds=time.perf_counter() - t0,
                    t0=t0,
                )
                writes.append(
                    (self.store.write_version, mb.local_vocab, new_rows)
                )
                out.append(m)
                if callback:
                    callback(m)
        finally:
            pf.close()
        self.store.flush()
        return out

    # ------------------------------------------------------------------

    def resume_step(self) -> int:
        """Restart point: minibatches already consumed (fault tolerance)."""
        return self.store.step
